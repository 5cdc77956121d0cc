"""Data parallelism (counterpart of `lavt_rs_tpu/parallel`)."""
