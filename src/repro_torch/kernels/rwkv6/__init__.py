"""RWKV6 chunked recurrence: the hand-written Hopper kernel (``rwkv6``), its
plain PyTorch version (``ref``) and the device dispatch (``ops``)."""
