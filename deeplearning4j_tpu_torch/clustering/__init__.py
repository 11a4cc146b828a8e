"""Clustering of the port (counterpart of ``deeplearning4j_tpu/clustering``):
device k-means and the host spatial trees."""
