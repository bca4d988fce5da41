"""Hand-written CUDA kernels of the port (sources in `repro_torch/csrc/`)
and their plain PyTorch versions. `ops` holds the wrappers the engines
call: a CPU tensor gets the plain version, a CUDA tensor the kernel."""
