"""Flash attention: the hand-written Hopper kernel (``flash``), its plain
PyTorch version (``ref``) and the device dispatch (``ops``)."""
