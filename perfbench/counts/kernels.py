"""Operations and bytes each kernel call needs, from shapes alone: what the
inputs require, not what a kernel happens to do (padding, masked tiles and
re-reads are not counted).  Operations count a multiply-add as two; bytes
count each bf16 input read once and each output written once.  A kernel's
roofline share is the sum over its calls of the least time the card could
take (yardstick.roofline) over its measured device time.

- K1 (causal prefill attention, left-padded rows): the visible pairs of the
  real tokens, n (n + 1) / 2 a row; q, k, v read and o written for the real
  tokens.
- K3 (ViT window attention): within each window of n tokens n^2 pairs.
- K4 (ViT frame-chunk attention): within each frame chunk of c tokens c^2
  pairs.
- K5 (ragged decode attention): per active slot and step, the live keys
  (its prompt's real tokens and the tokens decoded so far) read once, one
  query row per head; done slots need nothing.
- grouped GEMM (the MoE's two products): 2 x rows x 3 x hidden x expert
  width for fc1 (to 2 x width) and fc2 (back), each (token, expert) row
  once; bytes at least the weights of topk experts a layer (the ones any one
  token needs; which experts a step touches is not observed).
"""

from __future__ import annotations

from yardstick import causal_pairs

BF16 = 2


def attention_work(pairs: int, q_rows: int, kv_rows: int, H: int, Hkv: int,
                   D: int) -> tuple[float, float]:
    """(bytes, ops) of attention over `pairs` (query, key) pairs per head:
    QK^T and PV, 4 D operations a pair and head; q and o of q_rows rows,
    k and v of kv_rows rows."""
    ops = 4.0 * pairs * H * D
    nbytes = BF16 * D * (2 * q_rows * H + 2 * kv_rows * Hkv)
    return nbytes, ops


def k1_prefill(lengths, H: int, Hkv: int, D: int) -> tuple[float, float]:
    """One K1 call over left-padded prompts of these real lengths."""
    n = sum(lengths)
    return attention_work(causal_pairs(lengths), n, n, H, Hkv, D)


def vit_windows(grid, window_size: int, patch_size: int, merge: int) -> list:
    """Token counts of the windows of one (t, h, w) grid: windows of
    window_size // patch_size patches a side over each frame chunk, merged
    units kept whole, edge windows partial."""
    t, h, w = grid
    ws = window_size // merge // patch_size          # merge units a side
    lh, lw = h // merge, w // merge
    rows = [min(ws, lh - a) for a in range(0, lh, ws)]
    cols = [min(ws, lw - b) for b in range(0, lw, ws)]
    return [r * c * merge * merge for _ in range(t) for r in rows for c in cols]


def k3_vit(grid, vc: dict) -> tuple[float, float]:
    """Every windowed block of one video's ViT."""
    H, D = vc["num_heads"], vc["hidden_size"] // vc["num_heads"]
    blocks = vc["depth"] - len(vc["fullatt_block_indexes"])
    wins = vit_windows(grid, vc["window_size"], vc["patch_size"],
                       vc["spatial_merge_size"])
    b, o = attention_work(sum(n * n for n in wins), sum(wins), sum(wins), H, H, D)
    return blocks * b, blocks * o


def k4_vit(grid, vc: dict) -> tuple[float, float]:
    """Every full-attention block of one video's ViT."""
    t, h, w = grid
    H, D = vc["num_heads"], vc["hidden_size"] // vc["num_heads"]
    blocks = len(vc["fullatt_block_indexes"])
    c = h * w
    b, o = attention_work(t * c * c, t * c, t * c, H, H, D)
    return blocks * b, blocks * o


def k5_steps(prompt_len: int, steps: int, H: int, Hkv: int, D: int,
             first: int = 1) -> tuple[float, float]:
    """One slot's decode steps `first` .. `first + steps - 1` (the step that
    writes the slot's j-th generated token attends over prompt_len + j
    keys)."""
    keys = sum(prompt_len + j for j in range(first, first + steps))
    return attention_work(keys, steps, keys, H, Hkv, D)


def grouped_mm(rows: int, hidden: int, width: int) -> float:
    """Operations of the MoE's two grouped products over `rows` (token,
    expert) rows: fc1 hidden -> 2 width, fc2 width -> hidden."""
    return 2.0 * rows * 3 * hidden * width


def expert_bytes(experts: int, hidden: int, width: int) -> float:
    """Bytes of `experts` experts' fc1 and fc2 weights."""
    return BF16 * experts * 3 * hidden * width
