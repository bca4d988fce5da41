"""Fault injection for the port's serving path (`fault.py`)."""
