"""One driver per kind of traffic: set-up, window, traced stretch, check."""
