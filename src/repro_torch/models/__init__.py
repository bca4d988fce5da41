"""Models of the port: `xdeepfm` (serving and training, kernel K11 in
each CIN layer), the GNN family `gnn` (GIN, PNA, GatedGCN) and `nequip`,
the LM family `transformer` (dense and MoE; `attention`, `moe`),
and what they share (`common`: init, the cross-entropy, the segment
backend, parameter trees)."""
