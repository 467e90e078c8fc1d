"""Input data for the trainer: the TFRecord readers, the loader and the
device prefetcher (`pipeline.py`), and synthetic data (`synthetic.py`)."""
