"""Feature extraction layers of the PyTorch port."""
