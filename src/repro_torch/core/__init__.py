"""Index cores: k-means, product quantization, Vamana graphs, blob codecs."""
