"""The DCGAN generator and sampler."""
