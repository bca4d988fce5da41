"""PyTorch/CUDA port of the WC-Index system (`repro`), for one NVIDIA H100.

Mirrors the layout of `repro`: `core/` holds the graph, the index and the
serving engines, `kernels/` the hand-written CUDA kernels (sources in
`csrc/`) and their plain PyTorch versions. The package imports `torch`
and `numpy` only; it never imports `jax` or `repro`.

Entry points (`build_wc_index_batched_packed`, `DeviceQueryEngine`,
`WCSDServer`) run on the card unless the caller passes ``device="cpu"``.
"""
