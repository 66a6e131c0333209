"""Host utilities: the JSONL metrics stream."""
