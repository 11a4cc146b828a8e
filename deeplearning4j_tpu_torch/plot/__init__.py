"""Plotting of the port (counterpart of ``deeplearning4j_tpu/plot``):
exact and Barnes-Hut t-SNE, histograms, filter grids, embedding pages."""
