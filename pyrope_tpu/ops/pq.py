"""Product quantization: codebook training, encoding, ADC tables.

Rebuild of the reference's ``ProductQuantizer``
(ref: src/Pyrope.GarnetServer/Vector/ProductQuantizer.cs): codebooks
[m][k][subDim], requires dim % m == 0 and k ≤ 256 (:16-26); per-subspace
k-means with L2, 10 iterations, seed 42+m (:28-58); nearest-sub-centroid
encode (:60-80); decode (:82-96); per-query L2² distance table (:98-120).

On the device: training reuses the blocked k-means matmul, encoding is an [N, ksub]
score matmul per subspace, and the ADC table is one einsum
[B, M, sub] × [M, ksub, sub] -> [B, M, ksub].
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from pyrope_tpu.ops.kmeans import kmeans_assign, kmeans_train
from pyrope_tpu.types import Metric
from pyrope_tpu.utils.shapes import round_up


@dataclasses.dataclass
class ProductQuantizer:
    m: int                    # number of subspaces
    ksub: int                 # codes per subspace (≤ 256)
    dim: int
    codebooks: np.ndarray | None = None  # [m, ksub, sub]

    def __post_init__(self):
        if self.dim % self.m != 0:
            raise ValueError(f"dim {self.dim} not divisible by m {self.m}")
        if self.ksub > 256:
            raise ValueError("ksub must be <= 256 (uint8 codes)")
        self.sub = self.dim // self.m

    @property
    def trained(self) -> bool:
        return self.codebooks is not None

    def train(self, data: np.ndarray, *, seed: int = 42, iters: int = 10) -> None:
        """Per-subspace k-means on L2, seed 42+m (ref :28-58)."""
        data = np.asarray(data, np.float32)
        n = data.shape[0]
        ks = min(self.ksub, n)
        cbs = np.zeros((self.m, self.ksub, self.sub), np.float32)
        for mi in range(self.m):
            subdata = np.ascontiguousarray(data[:, mi * self.sub : (mi + 1) * self.sub])
            # sub-quantizers resolve fine residual structure: train in exact
            # fp32 (coarse IVF training uses the faster bf16 default)
            # reference-init subspace training (random sample, seed 42+m):
            # codebook quality is absorbed by the exact rerank stage, and
            # ++ seeding at ksub=256 would cost 256 sequential device steps
            # per subspace on this tiny-corpus fallback path
            c = kmeans_train(subdata, ks, Metric.L2, seed=seed + mi, iters=iters,
                             compute_dtype=None, init="sample")
            cbs[mi, : c.shape[0]] = c
            if c.shape[0] < self.ksub:
                # duplicate last centroid so unused codes stay harmless
                cbs[mi, c.shape[0] :] = c[-1]
        self.codebooks = cbs

    def encode(self, data: np.ndarray) -> np.ndarray:
        """[N, D] -> uint8 codes [N, m] (nearest sub-centroid, ref :60-80)."""
        assert self.codebooks is not None
        data = np.asarray(data, np.float32)
        codes = np.empty((data.shape[0], self.m), np.uint8)
        for mi in range(self.m):
            subdata = np.ascontiguousarray(data[:, mi * self.sub : (mi + 1) * self.sub])
            codes[:, mi] = kmeans_assign(subdata, self.codebooks[mi], Metric.L2).astype(np.uint8)
        return codes

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """uint8 codes [N, m] -> reconstruction [N, D] (ref :82-96)."""
        assert self.codebooks is not None
        codes = np.asarray(codes)
        out = np.empty((codes.shape[0], self.dim), np.float32)
        for mi in range(self.m):
            out[:, mi * self.sub : (mi + 1) * self.sub] = self.codebooks[mi][codes[:, mi]]
        return out

    def state(self) -> dict:
        return {
            "m": self.m,
            "ksub": self.ksub,
            "dim": self.dim,
            "codebooks": self.codebooks,
        }

    @classmethod
    def from_state(cls, st: dict) -> "ProductQuantizer":
        pq = cls(m=int(st["m"]), ksub=int(st["ksub"]), dim=int(st["dim"]))
        cb = st.get("codebooks")
        pq.codebooks = None if cb is None or np.size(cb) == 0 else np.asarray(cb, np.float32)
        return pq


def _sub_scores(xblk, cents, cc, compute):
    """Nearest-sub-centroid score 2*q·c - ||c||^2 (argmax == L2 argmin).
    ``compute``: None = fp32 HIGHEST (bit-stable), else operand cast dtype
    (bf16 runs on the tensor cores; the rerank stage absorbs the codebook
    perturbation — with rerank the ADC is only a shortlist ranker)."""
    if compute is None:
        d = jnp.einsum("bms,mks->mbk", xblk, cents,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    else:
        cd = jnp.dtype(compute)
        d = jnp.einsum("bms,mks->mbk", xblk.astype(cd), cents.astype(cd),
                       preferred_element_type=jnp.float32)
    return 2.0 * d - cc[:, None, :]


@functools.partial(jax.jit, static_argnames=("iters", "block", "compute"))
def _pq_lloyd(x, valid, cents0, *, iters: int, block: int, compute):
    """Batched Lloyd over ALL subspaces at once: x [Npad, M, S],
    valid [Npad], cents0 [M, K, S] -> [M, K, S]. One scan over row blocks
    per iteration; the m16 build's 16 sequential k-means (the r1 build-time
    killer, VERDICT r1 #3) collapse into one device program."""
    npad, m, s = x.shape
    kk = cents0.shape[1]
    xb = x.reshape(npad // block, block, m, s)
    vb = valid.reshape(-1, block)
    kiota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, kk), 2)

    def one_iter(cents, _):
        cc = jnp.sum(cents * cents, axis=-1)  # [M, K]

        def per_block(carry, inp):
            sums, counts = carry
            xblk, vblk = inp  # [B, M, S], [B]
            a = jnp.argmax(_sub_scores(xblk, cents, cc, compute), axis=-1)  # [M, B]
            onehot = (
                (a[..., None] == kiota) & vblk[None, :, None]
            ).astype(jnp.float32)                              # [M, B, K]
            # centroid update accumulates in fp32 regardless of compute;
            # HIGHEST keeps it a bit-exact segment-sum when compute is None
            sums = sums + jnp.einsum(
                "mbk,bms->mks", onehot, xblk,
                preferred_element_type=jnp.float32,
                precision=None if compute else jax.lax.Precision.HIGHEST,
            )
            counts = counts + jnp.sum(onehot, axis=1)
            return (sums, counts), None

        (sums, counts), _ = jax.lax.scan(
            per_block,
            (jnp.zeros((m, kk, s), jnp.float32), jnp.zeros((m, kk), jnp.float32)),
            (xb, vb),
        )
        new = sums / jnp.maximum(counts, 1.0)[..., None]
        # empty cluster keeps its previous centroid (ref KMeansUtils behavior)
        return jnp.where(counts[..., None] > 0, new, cents), None

    cents, _ = jax.lax.scan(one_iter, cents0, None, length=iters)
    return cents


@functools.partial(jax.jit, static_argnames=("block", "compute"))
def _pq_encode(x, cents, *, block: int, compute):
    """Blocked nearest sub-centroid for all subspaces: x [Npad, M, S],
    cents [M, K, S] -> codes [Npad, M] int32."""
    npad, m, s = x.shape
    xb = x.reshape(npad // block, block, m, s)
    cc = jnp.sum(cents * cents, axis=-1)

    def per_block(_, xblk):
        a = jnp.argmax(_sub_scores(xblk, cents, cc, compute), axis=-1)
        return None, a.astype(jnp.int32)

    _, a = jax.lax.scan(per_block, None, xb)  # [nblocks, M, B]
    return a.transpose(0, 2, 1).reshape(npad, m)


def pq_train_encode_device(
    r_dev: jax.Array,
    n: int,
    pq: "ProductQuantizer",
    *,
    seed: int = 42,
    iters: int = 10,
    block: int = 8192,
    compute: str | None = "bfloat16",
) -> tuple[np.ndarray, jax.Array]:
    """Train codebooks and encode on an already-device-resident residual
    buffer (rows >= n are padding). Same per-subspace seeds / init / Lloyd
    semantics as ProductQuantizer.train (ref: ProductQuantizer.cs:28-80) but
    batched over subspaces and with zero host->device re-upload.

    Returns (codebooks [m, ksub, sub] np, codes_dev [Npad, m] int32 device —
    callers permute it into the slab on device and slice [:n] on host).
    Requires n >= ksub (callers fall back to the host path below that).
    """
    m, ksub, sub = pq.m, pq.ksub, pq.sub
    npad0 = r_dev.shape[0]
    block = min(block, npad0)
    npad = round_up(npad0, block)
    x = r_dev.reshape(npad0, m, sub)
    if npad != npad0:
        x = jnp.pad(x, ((0, npad - npad0), (0, 0), (0, 0)))
    valid = np.zeros(npad, bool)
    valid[:n] = True

    # per-subspace random-sample init, seed 42+m (ref :28-58)
    init_rows = np.stack([
        np.random.default_rng(seed + mi).choice(n, size=ksub, replace=False)
        for mi in range(m)
    ])  # [m, ksub]
    cents0 = x[jnp.asarray(init_rows), jnp.arange(m)[:, None], :]  # [m, ksub, sub]

    cents = _pq_lloyd(x, jnp.asarray(valid), cents0, iters=iters, block=block,
                      compute=compute)
    # Final encode always fp32: train_dtype touches TRAINING matmuls only —
    # the stored codes are the index's truth, and a bf16 argmax moves
    # boundary rows to the wrong codeword (CLAUDE.md invariant; matches the
    # host fallback ProductQuantizer.encode and kmeans_build's fp32
    # final assignment).
    codes = _pq_encode(x, cents, block=block, compute=None)
    return np.asarray(cents), codes


def adc_l2_table(q: jax.Array, codebooks: jax.Array) -> jax.Array:
    """Per-query L2² lookup tables (ref: ComputeDistanceTable :98-120).

    q: [B, D] (already residual for IVF-PQ), codebooks: [M, ksub, sub].
    Returns [B, M, ksub] where table[b, m, k] = ‖q_sub(b, m) − cb[m, k]‖².
    """
    b, d = q.shape
    m, ksub, sub = codebooks.shape
    qs = q.reshape(b, m, sub)
    # HIGHEST: a default-precision fp32 einsum may run in TF32 on the GPU
    # and round every table entry the one-hot lookups then copy exactly
    dots = jnp.einsum(
        "bms,mks->bmk", qs, codebooks, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    qq = jnp.sum(qs * qs, axis=-1)                    # [B, M]
    cc = jnp.sum(codebooks * codebooks, axis=-1)      # [M, ksub]
    return qq[:, :, None] - 2.0 * dots + cc[None, :, :]


def adc_ip_table(q: jax.Array, codebooks: jax.Array) -> jax.Array:
    """Per-query dot-product lookup tables: table[b, m, k] = q_sub·cb[m, k]."""
    b, d = q.shape
    m, ksub, sub = codebooks.shape
    qs = q.reshape(b, m, sub)
    return jnp.einsum("bms,mks->bmk", qs, codebooks,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def adc_accumulate(table: jax.Array, codes: jax.Array, *, impl: str = "onehot") -> jax.Array:
    """Sum table entries selected by codes.

    table: [B, M, ksub] fp32; codes: [B, L, M] int32/uint8.
    Returns [B, L] = Σ_m table[b, m, codes[b, l, m]]
    (ref: IvfPqVectorIndex.cs:182-198 ADC accumulation loop).

    impl='onehot' re-expresses the table lookup as a one-hot × table matmul
    per subspace (PQTable / Quick-ADC lineage, see PAPERS.md): the
    [L, ksub] one-hot comparison is cheap elementwise work and the
    contraction is a matmul. impl='gather' is the direct take_along_axis
    form.
    """
    b, m, ksub = table.shape
    if impl == "gather":
        tbl_flat = table.reshape(b, m * ksub)
        moff = jax.lax.broadcasted_iota(jnp.int32, (1, 1, m), 2) * ksub
        idx = codes.astype(jnp.int32) + moff          # [B, L, M]
        gathered = jnp.take_along_axis(tbl_flat, idx.reshape(b, -1), axis=1)
        return jnp.sum(gathered.reshape(b, -1, m), axis=-1)
    # one-hot matmul: acc[b, l] = Σ_m Σ_k 1[codes[b,l,m]=k] · table[b,m,k].
    # fp32 with HIGHEST precision keeps this bit-faithful to the gather
    # (one-hot rows select exactly one fp32 table entry).
    kiota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, ksub), 2)  # [1,1,ksub]
    acc = None
    for mi in range(m):
        oh = (codes[:, :, mi].astype(jnp.int32)[:, :, None] == kiota).astype(
            jnp.float32
        )                                              # [B, L, ksub]
        part = jnp.einsum(
            "blk,bk->bl", oh, table[:, mi, :],
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        acc = part if acc is None else acc + part
    return acc


def adc_accumulate_shared(table: jax.Array, codes_all: jax.Array) -> jax.Array:
    """ADC accumulation against ONE shared code slab (dense scan).

    table: [B, M, ksub] fp32; codes_all: [N, M] uint8 — the same rows for
    every query (unlike ``adc_accumulate``'s per-query [B, L, M] blocks).
    Returns [B, N] = Σ_m table[b, m, codes_all[n, m]].

    Because the one-hot is per-row (not per-(query, row)) each subspace is
    a single [B, ksub] × [ksub, N] matmul over the whole slab — this is
    what makes the dense IVF-PQ scan one streaming pass instead of B
    replicated gathers. fp32 HIGHEST keeps it bit-faithful to a gather
    (one-hot rows select exactly one fp32 table entry).
    """
    m = codes_all.shape[1]
    kiota = jax.lax.broadcasted_iota(jnp.int32, (1, table.shape[2]), 1)  # [1, ksub]
    acc = None
    for mi in range(m):
        oh = (codes_all[:, mi].astype(jnp.int32)[:, None] == kiota).astype(
            jnp.float32
        )                                               # [N, ksub]
        part = jnp.einsum(
            "bk,nk->bn", table[:, mi, :], oh,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        acc = part if acc is None else acc + part
    return acc
