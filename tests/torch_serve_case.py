"""The scenarios and inputs of tests/test_torch_tp_serve.py, shared by its
two sides (not collected: ``tests/torch_dist_worker.py``'s ``serve`` jobs
run the port, ``tests/torch_dist_jax.py``'s ``main_serve`` the JAX
package). numpy only, so both import it.

A step case serves one arch on one (data, model) mesh through the serve
steps, from the JAX package's seed-0 weights at the mesh's geometry:

  1. ``prefill``: a whole batch of 2 x P tokens into a CACHE-position
     cache -> last logits, cache (attention, ssm and rec archs; not the
     frontend arch, whose whole-batch step the reference lowers without
     its prefix);
  2. ``prefill_slot``: one prompt in a P bucket (LEN real tokens; P for
     the recurrent archs, whose state is taken at the bucket's end) ->
     first token, cache; a frontend arch's F-row prefix ahead of it;
  3. ``decode_chunk``: that cache inserted at slot 1 of a zeroed 2-slot
     bank, GEN steps -> tokens, bank;
  4. paged (full-attention archs without a frontend): prompt A (PA
     tokens) through ``prefill_slot_paged`` into pages 1-3 of an
     N_PAGES pool, prompt B (A's first PFX tokens and SUF more) through
     the prefix-cached suffix prefill over pages 1-2 into page 4, then
     ``decode_chunk_paged`` of both rows over TABLE -> tokens, pool.

A pod case serves REQUESTS through a ``Pod`` (one replica, POD_SLOTS
slots of POD_MAX_LEN) and a ``ContinuousScheduler``; on a (data 2, ...)
mesh each data replica holds and decodes one row of the slot bank.
"""

import numpy as np

LLAMA = "llama3.2-3b-smoke"
# llama3.2-3b-smoke's reduction with 6 q heads: padded to 8 at model 4
PADDED = ("llama3.2-3b n_layers=2 d_model=64 n_heads=6 n_kv_heads=2 "
          "head_dim=16 d_ff=128 vocab_size=256")
MOE = "moonshot-v1-16b-a3b-smoke"
MAMBA = "mamba2-2.7b-smoke"
RGEMMA = "recurrentgemma-2b-smoke"
MUSIC = "musicgen-medium-smoke"

IMAGEFILE = """
FROM scratch
ARCH {arch}
SHAPE decode_32k seq_len=32 global_batch=2
MESH {mesh}
PRECISION compute=float32 params=float32
COLLECTIVES generic
{extra}"""

P, LEN, CACHE, GEN = 16, 13, 32, 4
PAGE, PA, PFX, SUF, N_PAGES, MAX_PAGES = 8, 24, 16, 8, 8, 8
TABLE = [[1, 2, 3, 5, 0, 0, 0, 0], [1, 2, 4, 6, 0, 0, 0, 0]]
BANK, SLOT = 2, 1

# (weights key) -> (arch, the tp its geometry is padded for)
WEIGHTS = {"l2": (LLAMA, 2), "l4": (LLAMA, 4), "pad": (PADDED, 4),
           "m2": (MOE, 2), "m4": (MOE, 4), "s2": (MAMBA, 2),
           "s4": (MAMBA, 4), "r2": (RGEMMA, 2), "r4": (RGEMMA, 4),
           "g2": (MUSIC, 2), "g4": (MUSIC, 4), "l1": (LLAMA, 1),
           "m1": (MOE, 1)}
RECURRENT = (MAMBA, RGEMMA)
PAGED = (LLAMA, PADDED, MOE)


def _step(name, arch, mesh, weights, fsdp=False):
    return {"name": name, "arch": arch, "mesh": list(mesh),
            "weights": weights, "fsdp": fsdp,
            "prefill": arch != MUSIC, "paged": arch in PAGED,
            "frontend": arch == MUSIC}


STEPS = [
    # (a) on a model axis
    _step("llama_12", LLAMA, (1, 2), "l2"),
    _step("llama_14", LLAMA, (1, 4), "l4"),
    _step("padded_14", PADDED, (1, 4), "pad"),
    _step("moe_12", MOE, (1, 2), "m2"),
    _step("moe_14", MOE, (1, 4), "m4"),
    _step("mamba_12", MAMBA, (1, 2), "s2"),
    _step("mamba_14", MAMBA, (1, 4), "s4"),
    _step("rgemma_12", RGEMMA, (1, 2), "r2"),
    _step("rgemma_14", RGEMMA, (1, 4), "r4"),
    _step("music_12", MUSIC, (1, 2), "g2"),
    _step("music_14", MUSIC, (1, 4), "g4"),
    # (b) from FSDP parts, on the rank's rows
    _step("fsdp_21", LLAMA, (2, 1), "l1", fsdp=True),
    _step("fsdp_22", LLAMA, (2, 2), "l2", fsdp=True),
]


def _pod(name, arch, mesh, weights, paged=False):
    return {"name": name, "arch": arch, "mesh": list(mesh),
            "weights": weights, "paged": paged}


PODS = [
    _pod("pod_llama_12", LLAMA, (1, 2), "l2"),
    _pod("pod_llama_14", LLAMA, (1, 4), "l4"),
    _pod("pod_paged_12", LLAMA, (1, 2), "l2", paged=True),
    _pod("pod_paged_14", LLAMA, (1, 4), "l4", paged=True),
    _pod("pod_rgemma_12", RGEMMA, (1, 2), "r2"),
    _pod("pod_rgemma_14", RGEMMA, (1, 4), "r4"),
    _pod("pod_moe_12", MOE, (1, 2), "m2"),
    _pod("pod_moe_14", MOE, (1, 4), "m4"),
    # a batch axis: each data replica decodes its row of the 2-slot bank
    _pod("pod_llama_21", LLAMA, (2, 1), "l1"),
    _pod("pod_paged_22", LLAMA, (2, 2), "l2", paged=True),
    _pod("pod_moe_21", MOE, (2, 1), "m1"),
]
POD_SLOTS, POD_MAX_LEN, POD_NEW, POD_PREFIX = 2, 64, 6, 8
POD_LENGTHS = (9, 16, 12, 12)


def mesh_name(mesh) -> str:
    """The platform name a JAX mesh of this shape is registered under."""
    return f"m{mesh[0]}{mesh[1]}"


def imagefile(case, mesh: str) -> str:
    return IMAGEFILE.format(arch=case["arch"], mesh=mesh,
                            extra="SET fsdp=true\n" if case.get("fsdp")
                            else "")


def step_inputs(vocab: int, d_model: int, fe_len: int, arch: str) -> dict:
    """Every input a step case reads, from one seed."""
    rng = np.random.default_rng(11)
    tok = lambda *s: rng.integers(1, vocab, s).astype(np.int32)  # noqa
    a = tok(1, PA)
    out = {"prefill": tok(2, P), "slot": tok(1, P),
           "length": np.int32(P if arch in RECURRENT else LEN),
           "paged_a": a,
           "paged_b": np.concatenate([a[:, :PFX], tok(1, SUF)], axis=1),
           "table": np.asarray(TABLE, np.int32)}
    if fe_len:
        out["fe"] = rng.standard_normal((1, fe_len, d_model)).astype(
            np.float32)
    return out


def requests_spec(vocab: int, paged: bool) -> list[dict]:
    """The pod case's requests: prompts of POD_LENGTHS tokens (sharing a
    POD_PREFIX-token block, declared shared, on a paged pod)."""
    rng = np.random.default_rng(12)
    shared = rng.integers(1, vocab, POD_PREFIX).astype(np.int32)
    out = []
    for i, n in enumerate(POD_LENGTHS):
        p = rng.integers(1, vocab, n).astype(np.int32)
        if paged and n > POD_PREFIX:
            p[:POD_PREFIX] = shared
        out.append({"rid": i, "prompt": p, "max_new_tokens": POD_NEW,
                    "prefix_len": POD_PREFIX if paged and n > POD_PREFIX
                    else 0})
    return out


def rows(batch: int, mesh, rank: int) -> slice:
    """The rows of a ``batch`` that ``rank`` of a (data, model) mesh holds:
    its data coordinate's share, or all where the replicas do not divide
    the batch."""
    d = mesh[0]
    if batch % d:
        return slice(0, batch)
    n = batch // d
    i = rank // mesh[1]
    return slice(i * n, (i + 1) * n)


TIE_VOCAB = 250


def tie_logits() -> np.ndarray:
    """(3, 256) logits over a vocab of TIE_VOCAB padded to 256: row 0's
    maximum in columns 70 and 200 (two ranks' slices at model 2 and 4),
    row 1's largest value in a padded column (masked) and its real one at
    10, row 2's in columns 5, 6 and 130."""
    x = np.random.default_rng(13).standard_normal((3, 256)).astype(
        np.float32)
    x[0, [70, 200]] = 9.0
    x[1, 252], x[1, 10] = 50.0, 8.0
    x[2, [5, 6, 130]] = 7.0
    return x
