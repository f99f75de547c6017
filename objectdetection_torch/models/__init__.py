"""ResNet-FPN backbone, RPN and ROI heads."""
