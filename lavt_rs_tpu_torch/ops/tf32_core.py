"""The host-side plan of the 3xTF32 GEMM core (csrc/gemm_tf32_sm90.cuh).

Every f32 GEMM of the port runs on it: `fused_msa.gemm_f32` (the
projections of K1, K2, K11, K2p and the save mode f32, fc1 + GELU and fc2
+ residual of K3 f32 and K8 f32), K7 f32's dual GEMM, weight grads and
dyln (`fused_mlp`), K5 f32's dattn, dx and weight grads.  Blocks of 384
threads (two consumer warpgroups of 64 rows on one 128 x 128 output tile,
a producer warpgroup: one TMA lane and 96 stagers), persistent, at most
one an SM; stages 32 deep.  B reaches the tensor cores as hi and lo tiles
(3xTF32).  A K-major B's lo comes split already (`fused_msa.tf32_lo`, once
a weight version or a call), brought by a third TMA load a stage beside
its raw tile, which is its hi; only an MN-major B takes the stagers, which
split it as they transpose it (`b_lo`).  tf32 wgmma reads its shared-memory
operand B K-major only and takes A from registers, so an operand stored
with the depth outermost (MN-major) is handled by its kind:
  * "gemm"  A (M, K), B (N, K), both K-major: nothing transposed;
  * "dual"  K7 f32's two products over one tile; W2 (C, 4C), read as
            (K, N), is copied transposed by a launch of its own first,
            which writes the copy's lo parts and W1's beside it;
  * "dgrad" A K-major, B a weight read as (K, N): the stagers transpose B
            as they split it;
  * "wgrad" A and B both (M, ·) with the depth M outermost: A's fragments
            are read in place, the stagers transpose B.
`plan` mirrors the C host side's tiles, blocks and shared memory;
`lavt_tf32_core_smem` gives the kernels' own figure on the card.
"""

from __future__ import annotations

TILE = 128            # rows and columns of a block's output tile
DEPTH = 32            # K of one stage: one 128-byte row of f32
THREADS = 384
OPERAND_STAGE = TILE * DEPTH * 4   # bytes of one operand's stage, 16 KB
STASH = 2 * 64 * TILE * 4          # the dual GEMM's first product, 64 KB
RED = 2 * 4 * TILE * 4             # the dual epilogue's column sums
SMEM_LIMIT = 232448                # an H100 block's dynamic shared memory
SMS = 132

# kind: (A MN-major, B MN-major (transposed by the stagers), dual)
KINDS = {"gemm": (False, False, False), "dual": (False, False, True),
         "dgrad": (False, True, False), "wgrad": (True, True, False)}
# the index of each kind in lavt_tf32_core_smem
SMEM_KIND = {"gemm": 0, "dual": 1, "dgrad": 2, "wgrad": 2}


def ring(kind: str) -> dict:
    """The shared memory of a kind's kernel: operand tiles a stage (A raw,
    B raw, B lo (by TMA for a K-major B) and, with B transposed, B hi),
    stages, bytes."""
    _, b_mn, dual = KINDS[kind]
    tiles = 4 if b_mn else 3
    stages = 3 if dual or b_mn else 4
    stage = tiles * OPERAND_STAGE
    smem = (stages * stage + (STASH + RED if dual else 0) + 3 * stages * 8
            + 1024)
    return {"operand_tiles": tiles, "stages": stages, "stage_bytes": stage,
            "smem": smem}


def transposed(kind: str) -> dict:
    """How each operand stored depth-outermost reaches the tensor cores:
    "stagers" (transposed in shared memory as it is split), "in place"
    (A's fragments read from the MN-major stage), "copy" (a transposed
    copy by a launch of its own); operands stored K-major are absent."""
    a_mn, b_mn, dual = KINDS[kind]
    out = {}
    if a_mn:
        out["A"] = "in place"
    if b_mn:
        out["B"] = "stagers"
    if dual:
        out["W2"] = "copy"
    return out


def b_lo(kind: str) -> str:
    """Where a kind's B gets its lo parts: "TMA" (a K-major B: split
    before the launch, brought beside its hi) or "stagers" (an MN-major B:
    split by the producer warpgroup's stagers as they transpose it)."""
    return "stagers" if KINDS[kind][1] else "TMA"


def plan(kind: str, m: int, n: int, k: int, splits: int = 1,
         sms: int = SMS) -> dict:
    """The launch of a kind over an (m, n) output of depth k (the weight
    grads: k = M, split `splits` ways): output tiles, k-tiles, blocks
    (persistent, at most one an SM over all splits), launches (the dual's
    copy and lo split beside its GEMM; a "gemm" given no lo takes one split
    launch more, `fused_msa.gemm_f32`), where B's lo comes from and the
    ring."""
    if kind not in KINDS:
        raise ValueError(f"tf32 core: unknown kind {kind!r}")
    m_tiles, n_tiles = -(-m // TILE), -(-n // TILE)
    out = {"m_tiles": m_tiles, "n_tiles": n_tiles,
           "tiles": m_tiles * n_tiles, "k_tiles": -(-k // DEPTH),
           "splits": splits,
           "blocks": max(1, min(m_tiles * n_tiles, sms // splits)),
           "launches": 2 if KINDS[kind][2] else 1, "b_lo": b_lo(kind)}
    out.update(ring(kind))
    return out
