"""Host utilities (numpy only)."""
