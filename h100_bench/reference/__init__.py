"""The plain reference of the benchmark's correctness check.

Plain PyTorch, written from the published description of the models and
not from the port: it imports neither JAX, nor the JAX package, nor
anything of ``sgnn_tpu_torch``. Its products run in float32 with TF32
off (``precision="f32"``); ``precision="tf32"`` rounds every product's
operands to TF32 first, the control of the check (the nearest precision
below the configuration's float32).
"""
