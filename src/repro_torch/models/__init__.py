"""The paper's task models."""
