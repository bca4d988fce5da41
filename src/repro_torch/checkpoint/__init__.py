"""Index persistence and the update WAL (`ckpt.py`), and fault injection
for the port's serving path (`fault.py`)."""
