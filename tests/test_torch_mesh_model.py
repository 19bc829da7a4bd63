"""The model's logical axes, their placements, and the prefill on a mesh.

- Every family's `param_axes` leaf by leaf against the reference's
  ``unbox(jax.eval_shape(init))[1]`` (its stacked leaves' leading
  "layers" dropped, one dictionary a layer, the hybrid's ``kind_*``
  markers left out, as `models/convert.py` carries the parameters).
- The port of tests/test_policy_hlo.py:76-101 (no mesh axis twice in one
  spec) over every arch, and `logical_placements` for every rule table
  `resolve` gives on the four-card mesh ``{"data": 2, "model": 2}``.
- Reduced granite-3-2b (4 layers, float32, the attention kernel's path,
  its plain version here) prefilled on a data 2 x model 2 mesh of four
  gloo ranks (`launch/dryrun.py::mesh_step`): hidden states and the last
  position's logits against the same port in one process within 1e-5
  (relative, plus 1e-5 of the largest magnitude: float32 products summed
  over two shards in another order), the greedy tokens the reference's,
  the attention run on each rank's local ``[B/2, S, H/2, hd]`` shards,
  and the collectives DTensor issued: 2 all-reduces a layer over the
  model groups (after the attention's and the MLP's output projections)
  and 1 after the vocabulary-sharded embedding, each of a
  ``[B/2, S, d]`` float32 operand, then the logits' all-gathers.
- The same for the other families whose prefill cells fit four cards,
  each reduced (its own depth, B 4 x S 32) and in a group of ranks of its
  own: yi-6b, starcoder2-7b, phi3-medium-14b, pixtral-12b (with its
  `embeds` prefix: the lookup is summed before the splice, which a
  vocabulary-sharded table otherwise refuses), recurrentgemma-2b,
  xlstm-1.3b, seamless-m4t-large-v2 and qwen2-moe-a2.7b: within 1e-5 of
  one process, the reference's greedy tokens, the attention and RG-LRU
  wrappers on plain local shards, `dryrun.prefill_counts`' all-reduces,
  and `dryrun.per_card_fit`'s argument bytes equal to each rank's.
- Every family's `cache_axes` against the reference's, and decode on the
  mesh (`launch/dryrun.py::mesh_decode`), in the same groups: B 4 from a
  filled cache of 32 positions (recurrentgemma's ring of 16 wraps), 3
  steps: every step's logits and every cache tensor within 1e-5 of one
  process (a bf16 cache within one bf16 step more), the reference's
  greedy tokens, each step's collectives equal to `dryrun.decode_counts`,
  no kernel on the path, the per-card estimate's argument bytes the
  ranks', and the mesh runner's own decode cell (its cache drawn shard by
  shard) against one process row by row. `seq_kv` on data 1 x model 4:
  reduced phi3-medium-14b with 12 heads over 3 KV heads, with and without
  a ring shorter than the cache (flash-decoding across the ranks' slots).
- `CollectiveStats`'s ring factors against the reference's
  `collective_stats` on an HLO text with one op of each kind, and the
  collective each redistribution issues (`partitioning.transition`).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import collective_stats as tcs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import FOUR_CARD, SINGLE_POD
from repro_torch.models import registry as tregistry
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import unembed
from repro_torch.sharding import partitioning as tpart
from repro_torch.sharding.policy import resolve, single_device_policy
from test_torch_multihost import run_ranks
from test_torch_reference import load_reference

ARCH = "granite-3-2b"
LAYERS, BATCH, SEQ = 4, 4, 16
FAKE_MESH = types.SimpleNamespace(mesh_dim_names=tuple(FOUR_CARD))


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def reference_axes(ref, cfg, pol, stacked):
    """The reference's axes tree in the port's layout."""
    jax, jnp = ref.jax, ref.jnp
    fam = ref.registry.get_family(cfg)
    boxed = jax.eval_shape(lambda k: fam.init_params(cfg, pol, k),
                           jax.ShapeDtypeStruct((2,), jnp.uint32))
    shapes, axes = ref.layers.unbox(boxed)

    def port(tree, drop):
        if isinstance(tree, dict):
            return {k: port(v, drop) for k, v in tree.items()
                    if not k.startswith("kind_")}
        assert not drop or tree[0] == "layers", tree
        return tree[1:] if drop else tree

    out = {}
    for k, v in axes.items():
        if k in stacked:
            n = jax.tree.leaves(shapes[k])[0].shape[0]
            out[k] = [port(v, True) for _ in range(n)]
        else:
            out[k] = port(v, False)
    return out


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_param_axes_are_the_reference(ref, arch, size):
    jc = (ref.configs.get_config(arch) if size == "full"
          else ref.configs.smoke_config(arch))
    tc = (tconfigs.get_config(arch) if size == "full"
          else tconfigs.smoke_config(arch))
    jpol = ref.policy.resolve(jc, SINGLE_POD, 256, "train", seq=4096)
    tpol = resolve(tc, SINGLE_POD, 256, "train", seq=4096)
    fam = tregistry.get_family(tc)
    got = fam.param_axes(tc, tpol)
    assert got == reference_axes(ref, jc, jpol, fam.STACKED_KEYS)
    # one axes tuple a parameter, of its rank
    params = fam.init_params(tc, tpol, torch.Generator().manual_seed(0)
                             if size == "reduced" else _meta())

    def check(t, ax):
        assert t.dim() == len(ax)

    _walk(check, params, got)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_cache_axes_are_the_reference(ref, arch, size):
    """Every family's `cache_axes` field by field against the reference's
    (`lm.py:178-180`, `hybrid.py:227-233`, `xlstm.py:362-369`,
    `encdec.py:148-151`): "layers" first, as both stack the cache's
    layers; one axes tuple a cache tensor, of its rank."""
    jc = (ref.configs.get_config(arch) if size == "full"
          else ref.configs.smoke_config(arch))
    tc = (tconfigs.get_config(arch) if size == "full"
          else tconfigs.smoke_config(arch))
    fam = tregistry.get_family(tc)
    got = dict(dryrun._fields(fam.cache_axes(tc)))
    assert got == ref.registry.get_family(jc).cache_axes(jc)._asdict()
    cache = fam.init_cache(tc, single_device_policy(tc), 2, 8,
                           device="meta")
    for name, t in dryrun._fields(cache):
        if isinstance(t, torch.Tensor):
            assert t.dim() == len(got[name]) and got[name][0] == "layers"
        else:
            assert got[name] == ()


def _meta():
    from repro_torch.device import meta_generator
    return meta_generator()


def _walk(fn, a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _walk(fn, a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _walk(fn, x, y)
    else:
        fn(a, b)


def _specs(tree):
    out = []
    tpart.map_axes(lambda ax: out.append(ax), tree)
    return out


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_policy_rules_have_no_duplicate_axes(arch):
    """tests/test_policy_hlo.py:76-101 on the port's axes trees."""
    cfg = tconfigs.get_config(arch)
    fam = tregistry.get_family(cfg)
    for step, batch in (("train", 256), ("decode", 128)):
        pol = resolve(cfg, SINGLE_POD, batch, step, seq=4096)
        for ax in _specs(fam.param_axes(cfg, pol)):
            flat = []
            for e in pol.spec(ax):
                if isinstance(e, tuple):
                    flat.extend(e)
                elif e is not None:
                    flat.append(e)
            assert len(flat) == len(set(flat)), (arch, step, ax)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
@pytest.mark.parametrize("step,batch,strategy", [
    ("prefill", 32, "auto"), ("decode", 128, "auto"), ("train", 256, "tp"),
    ("train", 256, "dp_zero1"), ("train", 256, "dp_zero3"),
    ("train", 256, "dp_seq")])
def test_placements_on_the_four_card_mesh(arch, step, batch, strategy):
    """Every leaf's placements under every rule table `resolve` gives on
    {"data": 2, "model": 2}: one a mesh dim, a Shard only where a rule
    names that mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = tconfigs.get_config(arch)
    pol = resolve(cfg, FOUR_CARD, batch, step, seq=4096, strategy=strategy)
    fam = tregistry.get_family(cfg)
    for ax in _specs(fam.param_axes(cfg, pol)) + [("batch", None)]:
        pl = tpart.logical_placements(FAKE_MESH, ax, pol.rules)
        assert len(pl) == 2
        spec = pol.spec(ax)
        for i, name in enumerate(FOUR_CARD):
            dims = [d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            assert pl[i] == (Shard(dims[0]) if dims else Replicate())


def test_granite_prefill_placements():
    """The cell's policy on four cards: batch over data; heads, kv heads,
    mlp and vocab over model; kv_repeat 1."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = tconfigs.get_config(ARCH)
    pol = resolve(cfg, FOUR_CARD, 32, "prefill", seq=32768)
    assert (pol.strategy, pol.attn_mode, pol.kv_repeat) == \
        ("serve", "tp_heads", 1)
    R = Replicate()
    want = {("vocab", "embed"): (R, Shard(0)),
            ("embed_fsdp", "heads"): (R, Shard(1)),
            ("heads", "embed_fsdp"): (R, Shard(0)),
            ("embed_fsdp", "mlp"): (R, Shard(1)),
            ("mlp", "embed_fsdp"): (R, Shard(0)),
            ("embed",): (R, R),
            ("batch", None): (Shard(0), R),
            ("attn_batch", "seq", "heads", None): (Shard(0), Shard(2))}
    for ax, pl in want.items():
        assert tpart.logical_placements(FAKE_MESH, ax, pol.rules) == pl


def test_logical_placements_refuse():
    with pytest.raises(ValueError, match="is not in the mesh"):
        tpart.logical_placements(FAKE_MESH, ("batch",))      # ("pod", ..)
    with pytest.raises(ValueError, match="shards two tensor dims"):
        tpart.logical_placements(FAKE_MESH, ("heads", "mlp"))
    with pytest.raises(ValueError, match="mesh order"):
        tpart.logical_placements(FAKE_MESH, ("x",),
                                 {"x": ("model", "data")})
    assert tpart.logical_placements(FAKE_MESH, ("x",),
                                    {"x": ("data", "model")})[1].dim == 0


@pytest.mark.parametrize("have,want,kind", [
    (("S0", "P"), ("S0", "R"), "all-reduce"),
    (("S0", "P"), ("S0", "S2"), "reduce-scatter"),
    (("S0", "S2"), ("S0", "R"), "all-gather"),
    (("S0", "S3"), ("S0", "S2"), "all-to-all"),
    (("S0", "R"), ("S0", "S2"), "slice"),
    (("S0", "P"), ("R", "R"), "all-gather+all-reduce")])
def test_transition_names_the_collective(have, want, kind):
    """What `timed_redistributions` files each redistribution under."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    place = {"R": Replicate(), "P": Partial(), "S0": Shard(0),
             "S2": Shard(2), "S3": Shard(3)}
    assert tpart.transition([place[p] for p in have],
                            [place[p] for p in want]) == kind


def test_constrain_is_the_identity_off_a_mesh():
    x = torch.ones(2, 3)
    assert tpart.constrain(x, "batch", None) is x
    assert tpart.shard_params_spec({"a": [("vocab", "embed")]}) == \
        {"a": [("model", None)]}


# ------------------------------------------------------------ on a mesh

_RANKS = r"""
import json, sys
import torch
from torch.distributed.tensor import Replicate, Shard
from repro_torch.launch import dryrun, mesh as tmesh, multihost
from repro_torch.launch.collective_stats import CollectiveRecorder
from repro_torch.models import hybrid, layers
from repro_torch.models.registry import get_family
from repro_torch.sharding import partitioning
from test_torch_mesh_model import (case_config, case_shape, decode_config,
                                   decode_shape, positions)

multihost.initialize(timeout_s=60, device="cpu")
case = torch.load(sys.argv[1] + "/case.pt")
m = tmesh.make_mesh(case.get("axes", tmesh.FOUR_CARD), "cpu")
seen, seen_lru = [], []
kernel, lru = layers.flash_attention, hybrid.chunked_lru


def spy(q, k, v, **kw):
    seen.append([type(q).__name__, list(q.shape), list(k.shape)])
    return kernel(q, k, v, **kw)


def spy_lru(a, bx, h0=None, **kw):
    seen_lru.append([type(a).__name__, list(a.shape), list(bx.shape)])
    return lru(a, bx, h0, **kw)


layers.flash_attention, hybrid.chunked_lru = spy, spy_lru
out = {}
if "tokens" in case:
    cfg, pol = case_config(**case["config"])
    inputs = {k: case[k] for k in ("tokens", "embeds")
              if case.get(k) is not None}
    fn, params, inputs = dryrun.mesh_step(cfg, pol, m, case["params"],
                                          inputs)
    with CollectiveRecorder() as rec:
        logits = fn()
    with torch.no_grad(), partitioning.mesh_context(m):
        hidden = get_family(cfg).forward(cfg, pol, params, inputs["tokens"],
                                         inputs.get("embeds"))[0]
        placements = tuple(hidden.placements) == (Shard(0), Replicate())
        hidden = hidden.full_tensor()
    layers.flash_attention, hybrid.chunked_lru = kernel, lru
    # the logits at some positions of the same prefill (`positions`)
    at, _, _ = dryrun.mesh_step(
        cfg, pol, m, case["params"],
        {k: case[k] for k in ("tokens", "embeds") if case.get(k) is not None},
        positions(case["config"]["seq"]))
    logits_at = at()
    if multihost.process_index() == 0:
        torch.save({"hidden": hidden, "logits": logits,
                    "logits_at": logits_at}, sys.argv[1] + "/out.pt")
    out.update({"ops": rec.ops, "hidden_placements": placements,
                "embed_local": list(params["embed"].to_local().shape),
                "tokens_local": list(inputs["tokens"].to_local().shape)})
    if "layers" in params:
        out["wq_local"] = list(
            params["layers"][0]["attn"]["wq"].to_local().shape)
    # the mesh runner's own draw of the same cell: its argument bytes a rank
    run, _ = dryrun.run_mesh_cell(cfg, pol, case_shape(**case["config"]), m,
                                  device="cpu")
    out["argument_bytes"] = [r["argument_bytes"] for r in run["ranks"]]
out.update({"seen": list(seen), "seen_lru": list(seen_lru)})
dec = case.get("decode")
if dec:
    # no attention or RG-LRU kernel on the decode path
    seen.clear(), seen_lru.clear()
    layers.flash_attention, hybrid.chunked_lru = spy, spy_lru
    # decode steps from the given cache, each step's collectives recorded
    cfg, pol = decode_config(**dec["config"])
    fam = get_family(cfg)
    params = dryrun.distribute(dec["params"], dryrun.param_specs(cfg, pol, m))
    cache = dryrun._with_fields(fam.init_cache(
        cfg, pol, dec["config"]["batch"], dec["config"]["seq"], device="cpu"),
        **dec["cache"])
    cache = dryrun.distribute_cache(cfg, pol, m, cache)
    tok_sh = dryrun.batch_sharding(cfg, pol, m, {"tokens": dec["tokens"][0]})
    got, ops = [], []
    for tok in dec["tokens"]:
        tok = dryrun.distribute(tok, tok_sh["tokens"])
        with torch.no_grad(), partitioning.mesh_context(m), \
                CollectiveRecorder() as rec:
            logits, cache = fam.decode_step(cfg, pol, params, cache, tok)
            got.append(dryrun._replicated(logits, m))
        ops.append(rec.ops)
    full = {name: t.full_tensor() for name, t in dryrun._fields(cache)
            if hasattr(t, "full_tensor")}
    if multihost.process_index() == 0:
        torch.save({"logits": torch.stack(got), "cache": full,
                    "pos": cache.pos}, sys.argv[1] + "/decode.pt")
    out["decode_ops"] = ops
    out["decode_cache_placements"] = {
        name: [str(p) for p in t.placements]
        for name, t in dryrun._fields(cache) if hasattr(t, "placements")}
    # the mesh runner's own draw of a decode cell of the same shape: its
    # argument bytes a rank, and each rank's parts of rows 0 and B - 1
    run, _ = dryrun.run_mesh_cell(cfg, pol, decode_shape(**dec["config"]), m,
                                  device="cpu",
                                  rows_out=sys.argv[1] + "/rows")
    out["decode_argument_bytes"] = [r["argument_bytes"] for r in run["ranks"]]
    out["decode_run_ops"] = run["collectives"]["op_count"]
    out["decode_seen"] = len(seen) + len(seen_lru)
print(json.dumps(out))
multihost.shutdown()
"""


#: the decode cases: B 4, a cache of DECODE_LEN slots filled with seeded
#: draws (`dryrun.filled_cache`), DECODE_STEPS steps from DECODE_POS
DECODE_BATCH, DECODE_LEN, DECODE_POS, DECODE_STEPS = 4, 36, 32, 3


def decode_config(arch=ARCH, n_layers=LAYERS, batch=DECODE_BATCH,
                  seq=DECODE_LEN, axes=None, overrides=None):
    """The reduced config of a decode case (`overrides` on top) and its
    decode policy on the mesh of `axes` (the four-card mesh by
    default)."""
    depth = {} if n_layers is None else {"n_layers": n_layers}
    cfg = tconfigs.smoke_config(arch, attention_impl="pallas", **depth,
                                **(overrides or {}))
    return cfg, resolve(cfg, axes or FOUR_CARD, batch, "decode", seq=seq)


def decode_shape(arch=ARCH, n_layers=LAYERS, batch=DECODE_BATCH,
                 seq=DECODE_LEN, axes=None, overrides=None):
    from repro_torch.configs import SHAPES
    import dataclasses
    return dataclasses.replace(SHAPES["decode_32k"], batch=batch, seq=seq)


def case_config(arch=ARCH, n_layers=LAYERS, batch=BATCH, seq=SEQ):
    """The reduced config (attention kernel's path, float32) and its
    prefill policy on the four-card mesh; `n_layers` None keeps the
    reduced config's own depth."""
    depth = {} if n_layers is None else {"n_layers": n_layers}
    cfg = tconfigs.smoke_config(arch, attention_impl="pallas", **depth)
    return cfg, resolve(cfg, FOUR_CARD, batch, "prefill", seq=seq)


def positions(seq):
    """The positions whose logits the rank script also asks for."""
    return (0, seq // 2, seq - 1)


def case_shape(arch=ARCH, n_layers=LAYERS, batch=BATCH, seq=SEQ):
    from repro_torch.configs import SHAPES
    import dataclasses
    return dataclasses.replace(SHAPES["prefill_32k"], batch=batch, seq=seq)


def reference_prefill(ref, arch, n_layers, batch, seq, overrides=None):
    """The reference's parameters (carried to the port) and its prefill
    of seeded numpy inputs: (port params, tokens, embeds or None,
    reference greedy tokens of the last position)."""
    depth = {} if n_layers is None else {"n_layers": n_layers}
    jc = ref.configs.smoke_config(arch, **depth, **(overrides or {}))
    jpol = ref.policy.single_device_policy(jc)
    jfam = ref.registry.get_family(jc)
    jp, _ = ref.layers.unbox(jfam.init_params(jc, jpol,
                                              ref.jax.random.PRNGKey(3)))
    cfg = tconfigs.smoke_config(arch, attention_impl="pallas", **depth,
                                **(overrides or {}))
    params = params_from_jax(cfg, ref.jax.tree.map(np.asarray, jp),
                             device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    embeds = None
    if cfg.family == "encdec":                   # the encoder's frames
        embeds = rng.standard_normal((batch, seq, cfg.d_model)) * 0.02
    elif cfg.embeds_input and cfg.n_prefix:      # a VLM's patch prefix
        embeds = rng.standard_normal((batch, cfg.n_prefix,
                                      cfg.d_model)) * 0.02
    if embeds is not None:
        embeds = embeds.astype(np.float32)
    jh, _ = jfam.forward(jc, jpol, jp, ref.jnp.asarray(tokens),
                         None if embeds is None else ref.jnp.asarray(embeds))
    jl = ref.layers.unembed(jc, jpol, jh[:, -1:], jp["embed"])
    return (params, torch.from_numpy(tokens),
            None if embeds is None else torch.from_numpy(embeds),
            np.argmax(np.asarray(jl)[:, -1], -1))


def reference_decode(ref, dconfig, params):
    """A decode case from the reference's parameters carried to the port
    (`params`): the cache (`dryrun.filled_cache`, seed 11, at the
    reference's single-device layout, its KV heads then repeated for the
    mesh's policy), DECODE_STEPS steps of seeded tokens from DECODE_POS,
    and the reference's `decode_step` on the same cache and tokens: (the
    cache at the mesh policy's layout, tokens [steps, B, 1], the
    reference's greedy tokens [steps, B])."""
    cfg, pol = decode_config(**dconfig)
    one = single_device_policy(cfg)
    B, T = dconfig["batch"], dconfig["seq"]
    cache = dryrun._at_position(dryrun.filled_cache(
        cfg, one, B, T, torch.Generator().manual_seed(11), "cpu"),
        DECODE_POS)
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, cfg.vocab_size, (DECODE_STEPS, B, 1)).astype(
        np.int32)
    depth = ({} if dconfig["n_layers"] is None
             else {"n_layers": dconfig["n_layers"]})
    jc = ref.configs.smoke_config(dconfig["arch"], **depth,
                                  **(dconfig["overrides"] or {}))
    jpol = ref.policy.single_device_policy(jc)
    jfam = ref.registry.get_family(jc)
    jp, _ = ref.layers.unbox(jfam.init_params(jc, jpol,
                                              ref.jax.random.PRNGKey(3)))
    jcache = jfam.init_cache(jc, jpol, B, T)
    jcache = jcache._replace(pos=ref.jnp.int32(DECODE_POS), **{
        f: ref.jnp.asarray(getattr(cache, f).float().numpy()).astype(
            getattr(jcache, f).dtype) for f in jcache._fields if f != "pos"})
    greedy = []
    for tok in tokens:
        jl, jcache = jfam.decode_step(jc, jpol, jp, jcache,
                                      ref.jnp.asarray(tok))
        greedy.append(np.argmax(np.asarray(jl)[:, -1, :cfg.vocab_size], -1))
    if pol.kv_repeat > 1:
        cache = dryrun._with_fields(cache, **{
            f: t.repeat_interleave(pol.kv_repeat, dim=3)
            for f, t in dryrun._fields(cache) if f in ("k", "v", "xk", "xv")})
    return cache, torch.from_numpy(tokens), np.stack(greedy)


def one_process_decode(cfg, pol, params, cache, tokens):
    """The decode steps in one process on plain tensors (a copy of
    `cache`): (logits [steps, B, 1, Vp], the cache after them)."""
    fam = tregistry.get_family(cfg)
    cache = dryrun._with_fields(cache, **{
        f: t.clone() for f, t in dryrun._fields(cache)
        if isinstance(t, torch.Tensor)})
    got = []
    with torch.no_grad():
        for tok in tokens:
            logits, cache = fam.decode_step(cfg, pol, params, cache, tok)
            got.append(logits)
    return torch.stack(got), cache


def mesh_case(ref, tmp, arch, n_layers, batch, seq, prefill=True,
              axes=None, overrides=None):
    """One family's cells run on a data 2 x model 2 mesh of four gloo ranks
    (its own group: no DTensor state carries from one family to the next)
    and in one process: a prefill of B x S (where `prefill`) and a decode
    case (DECODE_STEPS steps from a filled cache, on the mesh of
    `axes`)."""
    params, tokens, embeds, ref_tokens = reference_prefill(
        ref, arch, n_layers, batch, seq, overrides)
    config = dict(arch=arch, n_layers=n_layers, batch=batch, seq=seq)
    dconfig = dict(arch=arch, n_layers=n_layers, batch=DECODE_BATCH,
                   seq=DECODE_LEN, axes=axes, overrides=overrides)
    cache, dtokens, ref_greedy = reference_decode(ref, dconfig, params)
    case = {"decode": {"config": dconfig, "params": params,
                       "cache": dict(dryrun._fields(cache)),
                       "tokens": dtokens}, "axes": axes or FOUR_CARD}
    if prefill:
        case.update(params=params, tokens=tokens, embeds=embeds,
                    config=config)
    torch.save(case, tmp / "case.pt")
    outs = run_ranks(_RANKS, 4, tmp)
    run = types.SimpleNamespace(outs=outs, ref_tokens=ref_tokens,
                                config=config, params=params, tmp=tmp,
                                dconfig=dconfig, ref_greedy=ref_greedy,
                                dtokens=dtokens)
    run.dcfg, run.dpol = decode_config(**dconfig)
    run.dgot = torch.load(tmp / "decode.pt")
    run.dlogits, run.dcache = one_process_decode(run.dcfg, run.dpol, params,
                                                 cache, dtokens)
    if prefill:
        run.got = torch.load(tmp / "out.pt")
        run.cfg, run.pol = case_config(**config)
        fam = tregistry.get_family(run.cfg)
        with torch.no_grad():
            run.hidden = fam.forward(run.cfg, run.pol, params, tokens,
                                     embeds)[0]
            run.logits = unembed(run.cfg, run.pol, run.hidden[:, -1:],
                                 params["embed"])
    return run


@pytest.fixture(scope="module")
def mesh_run(ref, tmp_path_factory):
    """Reduced granite-3-2b: the reference's parameters carried to the
    port, run on the mesh and in one process; the reference's own forward
    for its greedy tokens."""
    return mesh_case(ref, tmp_path_factory.mktemp("mesh"), ARCH, LAYERS,
                     BATCH, SEQ)


def close(got, want, rel=1e-5):
    got, want = got.numpy(), want.numpy()
    bound = rel * np.abs(want) + rel * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound), \
        float(np.max(np.abs(got - want) - bound))


def test_mesh_prefill_matches_one_process(mesh_run):
    close(mesh_run.got["hidden"], mesh_run.hidden)
    # the vocabulary's logits: the padded entries are -1e30 on both sides
    V = mesh_run.cfg.vocab_size
    close(mesh_run.got["logits"][..., :V], mesh_run.logits[..., :V])
    assert torch.equal(mesh_run.got["logits"][..., V:],
                       mesh_run.logits[..., V:])
    for out in mesh_run.outs:
        assert out["hidden_placements"]        # batch over data only


def test_mesh_prefill_gives_the_reference_tokens(mesh_run):
    greedy = mesh_run.got["logits"][:, -1].argmax(-1).numpy()
    np.testing.assert_array_equal(greedy, mesh_run.ref_tokens)


def test_kernel_sees_local_shards(mesh_run):
    cfg = mesh_run.cfg
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    for out in mesh_run.outs:
        # one call a layer in each of the rank's two forwards, on plain
        # tensors: this rank's batch rows and heads, every position
        assert out["seen"] == [["Tensor", [BATCH // 2, SEQ, H // 2, hd],
                                [BATCH // 2, SEQ, KV // 2, hd]]] * (
                                    2 * LAYERS)
        assert out["wq_local"] == [d, H * hd // 2]
        assert out["embed_local"] == [256 // 2, d]
        assert out["tokens_local"] == [BATCH // 2, SEQ]


def test_counted_collectives(mesh_run):
    """2 all-reduces a layer + 1 (the embedding), over the model groups,
    each of one rank's [B/2, S, d] activations; then the logits' two
    all-gathers (batch over data, vocabulary over model)."""
    d = mesh_run.cfg.d_model
    for out in mesh_run.outs:
        ops = out["ops"]
        ar = [o for o in ops if o[0] == "all-reduce"]
        assert len(ar) == 2 * LAYERS + 1
        assert {(o[1], o[2]) for o in ar} == {(BATCH // 2 * SEQ * d * 4, 2)}
        assert [o[0] for o in ops[len(ar):]] == ["all-gather"] * 2
        stats = tcs.stats_of((o[0], o[1], o[2]) for o in ops)
        assert stats.op_count["all-reduce"] == 2 * LAYERS + 1
        assert stats.op_bytes["all-reduce"] == \
            (2 * LAYERS + 1) * BATCH // 2 * SEQ * d * 4


_HLO = """
HloModule one_of_each
%add (a: f32[], b: f32[]) -> f32[] {
  ROOT %r = f32[] add(%a, %b)
}
ENTRY %main (a: f32[8,128]) -> f32[8,128] {
  %ar = f32[8,128]{1,0} all-reduce(%x), replica_groups=[2,2]<=[4], to_apply=%add
  %ag = bf16[32,128]{1,0} all-gather(%s), replica_groups=[1,4]<=[4], dimensions={0}
  %rs = f32[4,64]{1,0} reduce-scatter(%y), replica_groups=[4,2]<=[8], dimensions={0}, to_apply=%add
  %aa = bf16[16,16]{1,0} all-to-all(%z), replica_groups=[1,8]<=[8], dimensions={0}
  %cp = f32[2,3]{1,0} collective-permute(%w), source_target_pairs={{0,1}}
  ROOT %o = f32[8,128] copy(%ar)
}
"""
# (opcode, result bytes, group size) of the ops above
_OPS = [("all-reduce", 8 * 128 * 4, 2), ("all-gather", 32 * 128 * 2, 4),
        ("reduce-scatter", 4 * 64 * 4, 2), ("all-to-all", 16 * 16 * 2, 8),
        ("collective-permute", 2 * 3 * 4, 2)]


def test_ring_factors_are_the_reference():
    from repro.launch.hlo_stats import collective_stats   # imports no JAX
    want = collective_stats(_HLO)
    got = tcs.stats_of(_OPS)
    assert got.op_count == want.op_count
    assert got.op_bytes == want.op_bytes
    assert got.link_bytes_per_device == pytest.approx(
        want.link_bytes_per_device, rel=1e-12)
    assert got.total_bytes() == want.total_bytes()


# ------------------------------------------------- every prefill family

#: the families whose prefill cells fit four cards (granite above), each
#: reduced (its own depth: 2 layers, 4 for the hybrid's (rec, rec, attn) +
#: tail, 8 for the xLSTM's 7:1, 2 + 2 for the encoder-decoder), B 4 x S 32
MESH_ARCHS = ("yi-6b", "starcoder2-7b", "phi3-medium-14b", "pixtral-12b",
              "recurrentgemma-2b", "xlstm-1.3b", "seamless-m4t-large-v2",
              "qwen2-moe-a2.7b")
FAMILY_BATCH, FAMILY_SEQ = 4, 32


@pytest.fixture(scope="module", params=MESH_ARCHS)
def family_run(request, ref, tmp_path_factory):
    arch = request.param
    return mesh_case(ref, tmp_path_factory.mktemp(arch), arch, None,
                     FAMILY_BATCH, FAMILY_SEQ)


def test_family_prefill_matches_one_process(family_run):
    close(family_run.got["hidden"], family_run.hidden)
    V = family_run.cfg.vocab_size
    close(family_run.got["logits"][..., :V], family_run.logits[..., :V])
    assert torch.equal(family_run.got["logits"][..., V:],
                       family_run.logits[..., V:])
    for out in family_run.outs:
        assert out["hidden_placements"]


def test_family_logits_at_positions(family_run):
    """`mesh_step(..., positions)`: the logits at those positions of the
    same prefill, against one process's hidden states there."""
    run = family_run
    pos = list(positions(run.config["seq"]))
    want = unembed(run.cfg, run.pol, run.hidden[:, pos],
                   run.params["embed"])
    V = run.cfg.vocab_size
    got = run.got["logits_at"]
    assert got.shape == want.shape
    close(got[..., :V], want[..., :V])
    assert torch.equal(got[..., V:], want[..., V:])


def test_family_prefill_gives_the_reference_tokens(family_run):
    greedy = family_run.got["logits"][:, -1].argmax(-1).numpy()
    np.testing.assert_array_equal(greedy, family_run.ref_tokens)


def test_family_kernels_see_local_shards(family_run):
    """The attention kernel once an attention layer (the encoder's too)
    and the RG-LRU once a recurrent layer, in each of the rank's two
    forwards, on plain tensors: this rank's batch rows and heads
    (``[B/2, S, H/2, hd]``, the KV heads after their repeat) or channels
    (``[B/2, S, dr/2]``)."""
    cfg, pol = family_run.cfg, family_run.pol
    counts = dryrun.prefill_counts(cfg)
    B, S = FAMILY_BATCH // 2, FAMILY_SEQ
    kvr = cfg.n_kv_heads * pol.kv_repeat
    dr = (cfg.d_rnn or cfg.d_model) // 2
    for out in family_run.outs:
        assert out["seen"] == [["Tensor", [B, S, cfg.n_heads // 2, cfg.hd],
                                [B, S, kvr // 2, cfg.hd]]] * (
                                    2 * counts["flash_attention"])
        assert out["seen_lru"] == [["Tensor", [B, S, dr], [B, S, dr]]] * (
            2 * counts["lru_forward"])
        assert out["tokens_local"] == [B, S]


def test_family_counted_collectives(family_run):
    """`dryrun.prefill_counts`' all-reduces, each of one rank's
    ``[B/2, S, d]`` float32 activations over the model groups; the hybrid's
    two gate products a recurrent layer reduce-scattered onto its
    channels."""
    cfg = family_run.cfg
    counts = dryrun.prefill_counts(cfg)
    act = FAMILY_BATCH // 2 * FAMILY_SEQ * cfg.d_model * 4
    # an MoE layer's aux-loss sums: [2, E] float32 over the data ranks
    aux = 2 * (family_run.pol.expert_pad or cfg.n_experts) * 4
    for out in family_run.outs:
        ar = [o for o in out["ops"] if o[0] == "all-reduce"]
        assert len(ar) == counts["all_reduces"] + counts.get(
            "aux_all_reduces", 0)
        assert {(o[1], o[2]) for o in ar if o[1] != aux or not cfg.n_experts
                } == {(act, 2)}
        assert sum(o[1] == aux for o in ar) == counts.get("aux_all_reduces",
                                                          0)
        rs = [o for o in out["ops"] if o[0] == "reduce-scatter"]
        assert len(rs) == 2 * counts["lru_forward"]
        assert out["ops"][-2:] == [["all-gather", o[1], 2, o[3]]
                                   for o in out["ops"][-2:]]


def test_family_per_card_estimate_is_the_ranks_arguments(family_run):
    """The per-card estimate's argument bytes (rank 0 of a fake group, on
    the meta device) are the bytes each gloo rank's mesh runner holds, and
    its meta step issues the all-reduces the ranks issued."""
    cfg, pol = family_run.cfg, family_run.pol
    fit = dryrun.per_card_fit(cfg, pol, case_shape(**family_run.config),
                              FOUR_CARD)
    at = fit["estimates"][str(fit["batch"])]
    for out in family_run.outs:
        assert out["argument_bytes"] == [at["argument_bytes"]] * 4
    counts = dryrun.prefill_counts(cfg)
    assert at["collective_count"]["all-reduce"] == \
        counts["all_reduces"] + counts.get("aux_all_reduces", 0)
    assert fit["fits_per_card"] and at["transient_bytes"] > 0


# ------------------------------------------------- decode on a mesh

BF16_STEP = 2.0 ** -7       # bf16's spacing, at most this of a value


def close_cache(got, want):
    """A cache tensor against one process's: within 1e-5 as `close`, and
    for a bf16 tensor (the KV caches, as the reference keeps them) also
    one bf16 step of each value: both sides round float32 values that
    agree within 1e-5 to bf16, and such a pair can round a step apart."""
    if want.dtype != torch.bfloat16:
        return close(got.float(), want.float())
    got, want = got.float().numpy(), want.float().numpy()
    bound = 1e-5 * (np.abs(want) + np.abs(want).max()) + \
        BF16_STEP * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), \
        float(np.max(np.abs(got - want) - bound))


def check_decode(run):
    """The mesh's decode steps against the same steps in one process:
    every step's logits and every cache tensor after them within 1e-5
    (`close_cache`), the padded vocabulary's -1e30 equal; the cache laid
    out on its `cache_axes`; no kernel launched."""
    V = run.dcfg.vocab_size
    got = run.dgot
    assert got["logits"].shape == run.dlogits.shape
    close(got["logits"][..., :V], run.dlogits[..., :V])
    assert torch.equal(got["logits"][..., V:], run.dlogits[..., V:])
    assert got["pos"] == run.dcache.pos == DECODE_POS + DECODE_STEPS
    want = {f: t for f, t in dryrun._fields(run.dcache)
            if isinstance(t, torch.Tensor)}
    assert got["cache"].keys() == want.keys()
    for f, t in want.items():
        assert got["cache"][f].dtype == t.dtype
        close_cache(got["cache"][f], t)
    from torch.distributed.tensor import Replicate, Shard  # noqa: F401
    places = dryrun.cache_placements(run.dcfg, run.dpol,
                                     types.SimpleNamespace(
                                         mesh_dim_names=tuple(FOUR_CARD)))
    for out in run.outs:
        assert out["decode_cache_placements"] == {
            f: [str(p) for p in pl] for f, pl in places.items()}
        assert out["decode_seen"] == 0      # no kernel on the decode path


def check_decode_tokens(run):
    greedy = run.dgot["logits"][:, :, -1, :run.dcfg.vocab_size].argmax(-1)
    np.testing.assert_array_equal(greedy.numpy(), run.ref_greedy)


def check_decode_collectives(run):
    """Each step's collectives, by kind, the logits' gathers to every rank
    included: `dryrun.decode_counts`' count and operand bytes."""
    want = dryrun.decode_counts(run.dcfg, run.dpol, DECODE_BATCH,
                                run.dconfig["axes"] or FOUR_CARD)
    for out in run.outs:
        for ops in out["decode_ops"]:
            stats = tcs.stats_of((o[0], o[1], o[2]) for o in ops)
            got = {k: [stats.op_count[k], stats.op_bytes[k]]
                   for k in stats.op_count}
            assert got == want, (got, want)


def check_decode_estimate(run):
    """The per-card estimate's argument bytes (rank 0 of a fake group) are
    each gloo rank's in the mesh runner's decode cell, and its meta step
    issues `decode_counts`' collectives."""
    axes = run.dconfig["axes"] or FOUR_CARD
    fit = dryrun.per_card_fit(run.dcfg, run.dpol,
                              decode_shape(**run.dconfig), axes)
    at = fit["estimates"][str(fit["batch"])]
    for out in run.outs:
        assert out["decode_argument_bytes"] == [at["argument_bytes"]] * 4
    want = dryrun.decode_counts(run.dcfg, run.dpol, DECODE_BATCH, axes)
    assert {k: [at["collective_count"][k], at["collective_bytes"][k]]
            for k in at["collective_count"]} == want
    assert fit["fits_per_card"] and at["transient_bytes"] > 0


def check_decode_rows(run):
    """The mesh runner's decode cell (its cache drawn shard by shard,
    RUN_WARM + RUN_STEPS steps at position seq - 1): each rank's parts of
    rows 0 and B - 1 after the steps against one process's run of the
    same cell (`dryrun.build_step`, the whole cache drawn at once)."""
    shape = decode_shape(**run.dconfig)
    step = dryrun.build_step(run.dcfg, run.dpol, shape, "cpu",
                             torch.Generator().manual_seed(0))
    for _ in range(dryrun.RUN_WARM + dryrun.RUN_STEPS):
        step.fn()
    want = dryrun.local_rows(step.state, [0, shape.batch - 1],
                             shape.seq - 1, shape.seq)
    seen = {f: 0 for f in want}
    for r in range(4):
        parts = torch.load(run.tmp / f"rows.rank{r}")
        assert parts.keys() == want.keys()
        for f, got in parts.items():
            whole = {row: (offs, t) for row, offs, t in want[f]}
            for row, offs, t in got:
                at, ref = whole[row]
                ref = ref[(slice(None),) + tuple(
                    slice(o - a, o - a + n)
                    for o, a, n in zip(offs, at, t.shape[1:]))]
                assert ref.shape == t.shape
                close_cache(t, ref)
                seen[f] += t.numel()
    for f, parts in want.items():     # every element of the rows is held
        assert seen[f] >= sum(t.numel() for _, _, t in parts)


DECODE_CHECKS = {"matches_one_process": check_decode,
                 "gives_the_reference_tokens": check_decode_tokens,
                 "counted_collectives": check_decode_collectives,
                 "per_card_estimate_is_the_ranks_arguments":
                     check_decode_estimate,
                 "runner_rows_match_one_process": check_decode_rows}


@pytest.mark.parametrize("check", DECODE_CHECKS)
def test_mesh_decode(mesh_run, check):
    """Reduced granite-3-2b decoding on data 2 x model 2 (`tp_heads`)."""
    DECODE_CHECKS[check](mesh_run)


@pytest.mark.parametrize("check", DECODE_CHECKS)
def test_family_decode(family_run, check):
    """Each family decoding on data 2 x model 2, reduced, float32, B 4,
    from a filled cache of 32 positions (recurrentgemma's ring of 16
    slots wrapped), 3 steps."""
    DECODE_CHECKS[check](family_run)


#: the `seq_kv` cases: reduced phi3-medium-14b with 12 heads over 3 KV
#: heads, which do not divide 4 (as phi3's 10 KV heads), on data 1 x model
#: 4: `resolve` gives `seq_kv` decode (the cache's time axis on "model");
#: "ring" with a local window of 16 slots, a ring shorter than the cache
SEQ_KV = {"plain": {"n_heads": 12, "n_kv_heads": 3},
          "ring": {"n_heads": 12, "n_kv_heads": 3, "local_window": 16}}
SEQ_KV_AXES = {"data": 1, "model": 4}


@pytest.fixture(scope="module", params=SEQ_KV)
def seq_kv_run(request, ref, tmp_path_factory):
    return mesh_case(ref, tmp_path_factory.mktemp("seq_kv"),
                     "phi3-medium-14b", None, FAMILY_BATCH, FAMILY_SEQ,
                     prefill=False, axes=SEQ_KV_AXES,
                     overrides=SEQ_KV[request.param])


@pytest.mark.parametrize("check", DECODE_CHECKS)
def test_seq_kv_decode(seq_kv_run, check):
    """Flash-decoding over a cache whose time axis is split over four
    ranks (a ring that wraps in the second case): the policy is `seq_kv`,
    and every check of the other families holds."""
    assert seq_kv_run.dpol.decode_attn == "seq_kv"
    assert seq_kv_run.dpol.rules["cache_seq"] == "model"
    DECODE_CHECKS[check](seq_kv_run)
