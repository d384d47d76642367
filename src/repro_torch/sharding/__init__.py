"""How the sharded server and the pod engine lay tensors over a mesh."""
