"""FET and CSS kernels: plain torch versions and their CUDA counterparts."""
