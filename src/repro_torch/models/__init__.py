"""The paper's task models (``small.py``) and the assigned architectures'
model code (``params``, ``layers``, ``ssm``, ``rglru``, ``model``)."""
