"""Scripts and fixture writers that sit beside the packages (not installed with them)."""
