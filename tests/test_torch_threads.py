"""The port's CPU tests run torch on one intra-op thread.

The suite runs in parallel workers on one host (``pytest -n 6 --dist
loadfile``), and each worker imports every test module while it
collects. torch's OpenMP pool defaults to one thread per core in every
worker, and six such pools that spin while they wait starve each other:
``test_torch_int8_cache.py::test_int8_gap_in_bf16_matches_jax_at_depth[512]``
took 38 s alone and 896 s in the suite on an 8-core host; six copies of
it at once took 73 s in all with one thread each, and had not finished
after 14 minutes with the default. Set here, at import, the limit holds for
every test of every worker; alone, that test takes 46 s with it. Results
do not depend on it: both sides of every bit-for-bit comparison run in
the same process."""
import torch

torch.set_num_threads(1)


def test_torch_runs_on_one_intra_op_thread():
    assert torch.get_num_threads() == 1
