"""EfficientNet backbone, BiFPN, heads, EfficientDet and the fast MC path."""
