"""PyTorch port operators."""
