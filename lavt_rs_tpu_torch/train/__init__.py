"""Training: the optimizer with the reference's param groups and the
train step (counterparts of `lavt_rs_tpu/train`)."""
