#!/usr/bin/env python3
"""Where the time of ring attention's hop goes on the card.

    python3 tools/ring_hop_split.py

The fused forward of ``chip_smoke.py`` (qwen3-1.7b, 8 PEs, tp = 2, cp = 2,
1,024 tokens a cp shard) runs each hop of ring attention as one launch of
the flash kernel's partial form over all 8 PEs folded into the batch. On
the second hop the 4 PEs of cp rank 0 receive keys that all lie ahead of
their queries: their rows see no key, and the kernel's contract for such a
row (m = -1e30, l = Sk, acc = the sum of v) still reads every key. This
times, on random bf16 inputs at that shape with that hop's positions, the
launch over all 8 PEs, over the 4 PEs that see keys, and over the 4 that
see none, each beside SDPA on the same rows and mask (output only) and the
bound of ``chip_smoke._bound``; one JSON line each. Needs one CUDA card
and nvcc (the kernels build into ``build/repro_torch/`` on first use).
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PES, CP, S_LOC, H, KV, HD = 8, 2, 1024, 8, 4, 128


def main() -> int:
    if not torch.cuda.is_available():
        print("ring_hop_split: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels.attention import flash
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v = cs._attn_inputs(gen, torch.bfloat16, PES, S_LOC, S_LOC, H, KV,
                              HD, dev)
    # cube (data 2, cp 2, tp 2) folded into the batch: PE b has cp rank
    # (b // 2) % 2; on hop 1 it holds the keys of the other cp rank
    rank = (torch.arange(PES, device=dev) // 2) % CP
    src = (rank - 1) % CP
    ar = torch.arange(S_LOC, device=dev)
    q_pos = (rank[:, None] * S_LOC + ar).to(torch.int32).contiguous()
    k_pos = (src[:, None] * S_LOC + ar).to(torch.int32).contiguous()
    rows = {"all": torch.arange(PES, device=dev),
            "sees_keys": torch.nonzero(rank == 1).flatten(),
            "sees_none": torch.nonzero(rank == 0).flatten()}
    kw = dict(causal=True, window=-1, partial=True)
    for name, idx in rows.items():
        t = [x[idx].contiguous() for x in (q, k, v, q_pos, k_pos)]
        print(json.dumps({
            "rows": name, "q": list(t[0].shape), "kv": list(t[1].shape),
            "ms": cs.time_ms(lambda: flash.flash_attention(*t, **kw)),
            "library_ms": cs._library_ms(
                cs.time_ms, lambda f: cs._sdpa(*t[:3], f), t[3], t[4],
                True, -1)[0],
            "library_output_only": True,
            **cs._bound(t[0], t[1], t[3], t[4], True, -1, True)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
