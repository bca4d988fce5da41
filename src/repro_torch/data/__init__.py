"""Synthetic input streams of the port's models (`recsys.CTRStream`)."""
