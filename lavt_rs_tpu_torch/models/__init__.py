"""nn.Module counterparts of lavt_rs_tpu.models (lavt_one path)."""
