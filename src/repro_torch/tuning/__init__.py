# The tuning subsystem (the counterpart of ``repro.tuning``): microbenchmark
# the registered collectives on the device through the real dispatch, fit
# per-(flow, stage, domain) alpha-beta models, persist them as
# fingerprint-keyed CommProfiles, and let the planner price candidates from
# measured data (``planner.install_profile`` / ``algorithm="auto"``).
from repro_torch.tuning.profile import (
    SCHEMA_VERSION, CommProfile, LinkModel, MeasuredSample, OverlapModel,
    OverlapSample, ProfileMismatchError, device_name, fingerprint_key,
    fit_models, fit_overlap, overlap_key, topology_fingerprint)
from repro_torch.tuning.microbench import (
    DEFAULT_OVERLAP_SIZES, DEFAULT_SIZES, measure_cell,
    measure_overlap_pair, measure_program, overlap_sweep, sweep)
from repro_torch.tuning.tuner import DEFAULT_CACHE_DIR, Tuner

__all__ = [
    "SCHEMA_VERSION", "CommProfile", "LinkModel", "MeasuredSample",
    "OverlapModel", "OverlapSample", "ProfileMismatchError", "device_name",
    "fingerprint_key", "fit_models", "fit_overlap", "overlap_key",
    "topology_fingerprint",
    "DEFAULT_OVERLAP_SIZES", "DEFAULT_SIZES", "measure_cell",
    "measure_overlap_pair", "measure_program", "overlap_sweep", "sweep",
    "DEFAULT_CACHE_DIR", "Tuner",
]
