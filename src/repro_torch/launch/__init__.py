"""Entry points that drive the assigned architectures (serving, federated
training), and the device mesh of the sharded server and the pod engine."""
