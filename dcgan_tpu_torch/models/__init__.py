"""The model families: `dcgan.py` (the DCGAN stacks, and the entry points
that dispatch on `ModelConfig.arch`), `resnet.py` (the residual G and the
norm-free critic) and `stylegan.py` (StyleGAN2-lite's G)."""
