"""Host data structures, the device-resident index builder and the
serving engines of the port (see `repro_torch`)."""
