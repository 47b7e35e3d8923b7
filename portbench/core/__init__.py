"""The harness: loading a cell, the run, the trace reduction and the
comparison with the plain reference."""
