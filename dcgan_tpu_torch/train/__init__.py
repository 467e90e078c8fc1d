"""The training slice: losses, the train step, the trainer loop and its
CLI (`python -m dcgan_tpu_torch.train`)."""
