"""PE-assisted reordering: the hand-written Hopper tile-swizzle kernel, its
plain PyTorch version and the device dispatch."""
