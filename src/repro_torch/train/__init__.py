"""Training of the port: optimizers (`optim`), the train step and its
host loop (`loop`), int8 gradient compression (`grad_compress`), and
the nested-dict helpers they share (`tree`)."""
