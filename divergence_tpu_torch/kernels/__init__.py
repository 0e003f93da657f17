"""FET kernels: plain torch versions and their CUDA counterparts."""
