"""Models of the port: `xdeepfm` (serving path, kernel K11 in each CIN
layer) and the init helper it shares (`common.trunc_normal`)."""
