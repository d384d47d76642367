from repro_torch.utils import pytree
from repro_torch.utils.registry import Registry

__all__ = ["pytree", "Registry"]
