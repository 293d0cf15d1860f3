"""Edge rows for the fused select step, as numpy (no torch, no JAX), shared
by the CPU parity test (port vs the reference) and the card test (kernel
vs plain version).

`case_inputs(case, V, cap, seed, bf16)` returns the step's inputs with
float32 logits that are exact in bf16 (rounded to nearest even), so one
case gives the same values in either dtype; `neg` is NEG_INF in the
dtype. `routes(x, cap)` says which route of the kernel each row
takes (the kernel's own rule, in numpy): "greedy", "list" (the
candidate list in shared memory) or "radix" (the multi-pass route).
"""
import numpy as np

CASES = ("ties", "fewer_allowed", "all_masked", "nucleus_only", "over_cap",
         "resample")
B, R = 4, 64


def bf16_round(x):
    """float32 -> the nearest bf16 value (ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def mask_np(x):
    """The masked logits of the inputs (float32, NEG = x["neg"])."""
    logits, store, rows = x["logits"], x["store"], x["rows"]
    V = logits.shape[1]
    words = np.zeros((logits.shape[0], store.shape[1]), np.uint32)
    for b in range(logits.shape[0]):
        for r in rows[b]:
            if r >= 0:
                words[b] |= store[r]
        if x["cd"] is not None:
            words[b] |= x["cd"][b]
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    allow = bits.reshape(len(words), -1)[:, :V].astype(bool)
    allow[:, 1] |= x["eos"]
    allow |= ~x["cons"][:, None]
    return np.where(allow, logits, np.float32(x["neg"])).astype(np.float32)


def _key(f):
    u = np.ascontiguousarray(f, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def routes(x, cap):
    """Per row: "greedy", "list" or "radix", by the kernel's rule. Bins
    are the top 12 bits of the unscaled values' keys. A sampled row with
    fewer than top_k entries above NEG lists them all; one with
    0 < top_k < V and top_k <= cap lists the entries at or above the bin
    of rank top_k; one with top_k off and top_p < 1 those at or above the
    bin below the one where the exp-mass from the top reaches top_p of
    the total. It takes the
    list when they fit cap (the kernel's later checks, for values that
    collide after the division or a cut below the list, do not fire on
    these cases)."""
    masked = mask_np(x)
    V = masked.shape[1]
    out = []
    for b in range(len(masked)):
        k, p = int(x["top_k"][b]), float(x["top_p"][b])
        t = np.float32(max(x["temp"][b], 1e-6))
        digit = _key(masked[b]) >> 20
        if x["greedy"][b]:
            out.append("greedy")
            continue
        real = masked[b] != np.float32(x["neg"])
        if 0 < k < V and k <= cap and real.sum() < k and real.any() and \
                masked[b][real].min() > x["neg"]:
            out.append("list")          # every entry above NEG, top-k off
            continue
        if 0 < k < V:
            if k > cap:
                out.append("radix")
                continue
            d = np.sort(digit)[::-1][k - 1]
        elif p < 1.0:
            # fixed-point mass, 2^31 / V per unit; one bin of margin
            scale = np.float32(np.floor(2.0 ** 31 / V))
            e = np.exp(masked[b] / t - np.float32(masked[b].max() / t))
            mass = np.bincount(digit, weights=np.rint(e * scale),
                               minlength=1 << 12)
            target = int(np.float32(p) * np.float32(mass.sum()))
            d = np.nonzero(np.cumsum(mass[::-1])[::-1] >= target)[0][-1]
            d = max(d - 1, 0)
        else:
            out.append("radix")
            continue
        out.append("list" if int((digit >= d).sum()) <= cap else "radix")
    return out


def case_inputs(case, V, cap, seed=0, bf16=False):
    """One edge case at vocab V: dict of the step's numpy inputs."""
    rng = np.random.default_rng(seed)
    W = V // 32
    neg = float(bf16_round(np.float32([-1e30]))[0]) if bf16 else -1e30

    def sparse(n_and):                      # density 2 ** -n_and
        bits = rng.integers(0, 2 ** 32, size=(R, W), dtype=np.uint32)
        for _ in range(n_and - 1):
            bits &= rng.integers(0, 2 ** 32, size=(R, W), dtype=np.uint32)
        return bits

    x = dict(store=sparse(4), rows=rng.integers(0, R, size=(B, 2))
             .astype(np.int32), cd=np.zeros((B, W), np.uint32),
             logits=bf16_round(rng.normal(size=(B, V)) * 3),
             eos=np.array([True, False, True, False]),
             cons=np.ones(B, bool),
             greedy=np.array([False, False, False, True]),
             temp=np.array([0.8, 1.0, 0.7, 1.3], np.float32),
             top_k=np.full(B, 40, np.int32),
             top_p=np.array([0.95, 1.0, 0.9, 0.95], np.float32),
             keys=rng.integers(0, 2 ** 32, size=(B, 2), dtype=np.uint32),
             neg=neg)
    if case == "ties":
        # 81 values a quarter apart: every bin holds many equal keys
        x["logits"] = (rng.integers(-40, 41, size=(B, V)) / 4).astype(
            np.float32)
        x["cons"][1] = False                # one row with every id allowed
        x["top_k"][1] = 5
    elif case == "fewer_allowed":
        # a handful of allowed ids per row, fewer than top_k
        x["store"] = np.zeros((R, W), np.uint32)
        for r in range(R):
            ids = rng.choice(V, size=int(rng.integers(3, 30)), replace=False)
            for i in ids:
                x["store"][r, i >> 5] |= np.uint32(1 << (i & 31))
        x["rows"][:, 1] = -1
        x["top_p"][:] = [0.95, 1.0, 0.5, 0.95]
    elif case == "all_masked":
        x["rows"][:] = -1
        x["eos"][:] = False
        x["top_k"][:] = [40, 0, cap + 1, 40]
        x["top_p"][:] = [0.95, 0.9, 1.0, 0.95]
    elif case == "nucleus_only":
        x["top_k"][:] = 0
        x["top_p"][:] = [0.9, 0.5, 0.99, 0.95]
        x["cons"][2] = False
    elif case == "over_cap":
        # row 0: top_k above the list's capacity; row 1: cap + 64 entries
        # tie at the top, so the candidate set of rank 40 overflows
        x["top_k"][0] = cap + 1
        x["cons"][1] = False
        top = rng.choice(V, size=cap + 64, replace=False)
        x["logits"][1, top] = 12.0
        x["top_p"][1] = 0.95
    elif case == "resample":
        # the engine's resample form: masked rows in, unconstrained, one
        # id (the row's argmax) banned
        masked = mask_np(x)
        masked[np.arange(B), masked.argmax(-1)] = np.float32(neg)
        x.update(logits=masked, rows=np.full((B, 1), -1, np.int32), cd=None,
                 eos=np.zeros(B, bool), cons=np.zeros(B, bool))
    else:
        raise ValueError(case)
    return x


EXPECTED_ROUTES = {"ties": {"list"}, "fewer_allowed": {"list"},
                   "all_masked": {"radix"}, "nucleus_only": {"list"},
                   "over_cap": {"list", "radix"}, "resample": {"list"}}
