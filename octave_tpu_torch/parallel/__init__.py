"""Data parallelism over several devices: training over processes (`ddp.py`),
serving over a mesh of devices in one program (`mesh.py`)."""
