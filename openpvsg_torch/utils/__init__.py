"""Host utilities: the JSONL metrics stream, timers and tracing."""
