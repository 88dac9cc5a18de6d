"""Dataset-side device stages of the PyTorch port."""
