"""Plain PyTorch references of what the benchmark's cells compute. They import
nothing of the program (``cuembed_tpu_torch``) and nothing of JAX, and take
only the inputs the benchmark made."""
