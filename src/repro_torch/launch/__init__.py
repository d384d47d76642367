"""Entry points that drive the assigned architectures: serving."""
