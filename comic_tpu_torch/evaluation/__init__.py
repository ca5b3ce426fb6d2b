"""Caption JSON output."""
