"""Host and device preprocessing."""
