"""Input data for the trainer: the synthetic stream (the TFRecord readers
are a later slice)."""
