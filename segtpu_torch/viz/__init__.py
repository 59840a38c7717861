"""The visualization trio of the port."""

from segtpu_torch.viz.plots import (plot_broadband_vs_fluorescence,
                                    plot_class_imbalance,
                                    visualize_predictions)
