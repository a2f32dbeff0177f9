"""The plain reference that decides `correct`: float32 PyTorch and NumPy,
TF32 off, written from the DSen2 paper and the reference code, importing
nothing of dsen2_tpu_torch and taking nothing the program made."""
