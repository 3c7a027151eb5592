"""The harness: cells found by name, the run, the trace, the yardstick."""
