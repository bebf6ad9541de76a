"""Data parallelism over several devices (`ddp.py`)."""
