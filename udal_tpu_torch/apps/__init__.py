"""Application layer: the serving driver, calibration, thresholding, auto-labeling and
validation."""
