"""Training-loop utilities (counterpart of `lavt_rs_tpu/utils`)."""
