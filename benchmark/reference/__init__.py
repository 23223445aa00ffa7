"""The plain reference: f32 PyTorch ops, no kernel, no ``tpu_ac_torch``."""
