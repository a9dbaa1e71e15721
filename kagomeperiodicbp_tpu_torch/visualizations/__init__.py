from .plots import ITEPlots, plot_block, plot_tracker

__all__ = ["ITEPlots", "plot_block", "plot_tracker"]
