"""Synthetic inputs of the port's models (`recsys.CTRStream`) and the
graph pipeline (`graphs`: the neighbor sampler, padded blocks, synthetic
graph tasks, WC-INDEX distance encodings) and the LM family's
`lm.TokenStream`."""
