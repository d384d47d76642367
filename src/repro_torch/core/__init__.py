"""AsyncFedED core: the paper's protocol as composable pieces."""
