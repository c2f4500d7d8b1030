"""The plain reference renderer that decides ``correct``: plain PyTorch
and numpy, importing neither the program (``bibim_tpu_torch``) nor the JAX
package."""
