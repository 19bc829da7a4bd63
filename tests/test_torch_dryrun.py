"""The assigned cell grid and the port's dry run (`launch/dryrun.py`).

`cells`, `skipped_cells` and `input_specs` against the reference's
(32 runnable cells and 8 recorded skips; every input's key, shape and
dtype); the meta build of one cell of each kind (its record's keys, a
parameter count equal to the reference's `eval_shape` tree under the same
resolved policy, nothing allocated); `MetaRun`'s accounting (bytes live
and at their peak, FLOPs equal to `FlopCounterMode`'s, the shape cache
changing nothing); a decode cell's step from a filled cache at position
``seq - 1`` against the reference's `decode_step` on the same cache,
carried across as numpy, within 1e-5; and ``--run`` refusing the CPU.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.models import xlstm as txlstm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import make_decode_logits_step
from repro_torch.sharding.policy import resolve, single_device_policy
from test_torch_reference import load_reference

META = torch.device("meta")
STEP_RTOL = 1e-5
MESH1 = {"data": 16, "model": 16}
RECORD_KEYS = {
    "arch", "shape", "kind", "batch", "seq", "mesh", "devices", "policy",
    "attention_impl", "remat", "params", "param_bytes", "analysis_params",
    "active_params", "moment_bytes", "cache_bytes", "input_bytes",
    "argument_bytes", "transient_bytes", "peak_bytes_estimate",
    "fits_one_card", "tokens", "flops", "flops_analytic", "meta_seconds",
    "ok"}


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def test_cells_and_skips_equal_the_reference(ref):
    assert tconfigs.cells() == ref.configs.cells()
    assert len(tconfigs.cells()) == 32
    assert tconfigs.skipped_cells() == ref.configs.skipped_cells()
    assert len(tconfigs.skipped_cells()) == 8
    assert tconfigs.LONG_CONTEXT_ARCHS == ref.configs.LONG_CONTEXT_ARCHS
    for name, s in tconfigs.SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(
            ref.configs.SHAPES[name])


@pytest.mark.parametrize("arch,shape", tconfigs.cells())
def test_input_specs_equal_the_reference(ref, arch, shape):
    want = ref.configs.input_specs(ref.configs.get_config(arch),
                                   ref.configs.SHAPES[shape])
    got = tconfigs.input_specs(tconfigs.get_config(arch),
                               tconfigs.SHAPES[shape])
    assert list(got) == list(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert str(got[k].dtype) == f"torch.{np.dtype(spec.dtype).name}", k
        assert got[k].device == META


def reference_param_count(ref, arch, shape):
    s = ref.configs.SHAPES[shape]
    jc = ref.configs.get_config(arch)
    pol = ref.policy.resolve(jc, MESH1, s.batch, s.kind, seq=s.seq)
    fam = ref.registry.get_family(jc)
    boxed = ref.jax.eval_shape(lambda k: fam.init_params(jc, pol, k),
                               ref.jax.ShapeDtypeStruct((2,),
                                                        ref.jnp.uint32))
    # through convert.py, which drops the hybrid's kind_* markers
    tree = params_from_jax(tconfigs.get_config(arch),
                           ref.layers.unbox(boxed)[0], device="meta")
    return sum(t.numel() for t in dryrun.tensors_of(tree))


@pytest.mark.parametrize("arch,shape", [
    ("granite-3-2b", "decode_32k"), ("seamless-m4t-large-v2", "prefill_32k"),
    ("recurrentgemma-2b", "train_4k")])
def test_meta_dry_run_of_one_cell_of_each_kind(ref, arch, shape):
    rec = dryrun.lower_cell(arch, shape)
    assert set(rec) == RECORD_KEYS | ({"min_cards", "min_cards_is"}
                                      if not rec["fits_one_card"] else set())
    s = tconfigs.SHAPES[shape]
    assert (rec["kind"], rec["batch"], rec["seq"]) == (s.kind, s.batch,
                                                       s.seq)
    assert rec["mesh"] == "16x16" and rec["devices"] == 256
    assert rec["params"] == reference_param_count(ref, arch, shape)
    assert rec["param_bytes"] == 2 * rec["params"] or s.kind == "train"
    assert rec["argument_bytes"] == (rec["param_bytes"] + rec["moment_bytes"]
                                     + rec["cache_bytes"]
                                     + rec["input_bytes"])
    assert rec["peak_bytes_estimate"] == (rec["argument_bytes"]
                                          + rec["transient_bytes"])
    assert rec["transient_bytes"] > 0 and rec["flops"] > 0
    assert rec["tokens"] == s.batch * (1 if s.kind == "decode" else s.seq)
    assert rec["fits_one_card"] == (rec["peak_bytes_estimate"]
                                    <= 0.9 * dryrun.CARD_BYTES)
    want_pol = ref.policy.resolve(ref.configs.get_config(arch), MESH1,
                                  s.batch, s.kind, seq=s.seq)
    assert rec["policy"]["notes"] == list(want_pol.notes)
    assert rec["policy"]["kv_repeat"] == want_pol.kv_repeat
    if s.kind == "train":
        assert rec["moment_bytes"] == 2 * 4 * rec["params"]
        assert rec["flops_analytic"] == 6 * rec["active_params"] * \
            rec["tokens"]
    if s.kind == "decode":
        assert rec["cache_bytes"] > 0 and rec["min_cards"] >= 2


def test_a_cell_that_fits_fits():
    rec = dryrun.lower_cell("recurrentgemma-2b", "long_500k")
    assert rec["fits_one_card"] and "min_cards" not in rec
    assert rec["peak_bytes_estimate"] < 0.9 * dryrun.CARD_BYTES


def test_step_is_built_on_meta_without_drawing():
    cfg = dryrun.cell_config("qwen2-moe-a2.7b")
    s = tconfigs.SHAPES["decode_32k"]
    pol = resolve(cfg, MESH1, s.batch, s.kind, seq=s.seq)
    step = dryrun.build_step(cfg, pol, s, META)
    leaves = step.argument_tensors()
    assert leaves and all(t.device == META for t in leaves)
    assert step.params["layers"][0]["moe"]["wi"].shape[0] == 64   # padded
    assert step.state.pos == s.seq - 1


class TestMetaRun:
    def test_bytes_live_and_at_their_peak(self):
        a = torch.empty((1000,), device=META)
        with dryrun.MetaRun(exclude=[a]) as run:
            b = a * 2                       # 4000 B
            v = b[10:]                      # a view: nothing
            c = b + 1                       # 4000 B, peak 8000
            del b                           # v keeps b's storage
            assert run.live == 8000
            del v
            assert run.live == 4000
            a.add_(1)                       # in place on an argument
            d = torch.empty((250,), device=META, dtype=torch.float64)
        assert run.peak == 8000 and run.live == 6000
        del c, d

    @pytest.mark.parametrize("arch,shape,seq", [
        ("xlstm-1.3b", "prefill_32k", 96), ("recurrentgemma-2b", "train_4k",
                                            64),
        ("qwen2-moe-a2.7b", "decode_32k", 32)])
    def test_flops_and_bytes_with_and_without_the_shape_cache(
            self, monkeypatch, arch, shape, seq):
        """Reduced configs: FLOPs equal FlopCounterMode's total over the
        same step, and the shape cache changes neither count."""
        cfg = tconfigs.smoke_config(arch, attention_impl="pallas")
        s = dataclasses.replace(tconfigs.SHAPES[shape], seq=seq, batch=2)
        pol = resolve(cfg, MESH1, s.batch, s.kind, seq=s.seq)
        counts = []
        for cached in (True, False):
            if not cached:
                monkeypatch.setattr(dryrun.MetaRun, "_key",
                                    lambda *a: None)
            step = dryrun.build_step(cfg, pol, s, META)
            with dryrun.MetaRun(exclude=step.argument_tensors()) as run:
                step.fn()
            counts.append((run.flops, run.peak))
            if cached:
                assert run.hits > 0
        assert counts[0] == counts[1]
        # FlopCounterMode counts what runs: the xLSTM's loops step by step
        monkeypatch.setattr(txlstm, "META_LOOP_BY_COUNT", False)
        step = dryrun.build_step(cfg, pol, s, META)
        with FlopCounterMode(display=False) as fc:
            step.fn()
        assert counts[0][0] == fc.get_total_flops() > 0

    @pytest.mark.parametrize("shape,seq", [("prefill_32k", 200),
                                           ("train_4k", 72)])
    def test_xlstm_loops_counted_from_one_step(self, monkeypatch, shape,
                                               seq):
        """The sLSTM's time loop (and, without autograd, the mLSTM's chunk
        loop) run on meta as their first two steps, the second counted for
        the rest: the same FLOPs and the same peak bytes, exactly, as every
        step run one by one, forward and (train) backward, under remat."""
        cfg = tconfigs.smoke_config("xlstm-1.3b", attention_impl="pallas",
                                    remat="full")
        s = dataclasses.replace(tconfigs.SHAPES[shape], seq=seq, batch=2)
        pol = resolve(cfg, MESH1, s.batch, s.kind, seq=s.seq)
        one_step = txlstm._slstm_step
        got = {}
        for by_count in (True, False):
            monkeypatch.setattr(txlstm, "META_LOOP_BY_COUNT", by_count)
            steps = []
            monkeypatch.setattr(txlstm, "_slstm_step", lambda *a: (
                steps.append(1), one_step(*a))[1])
            step = dryrun.build_step(cfg, pol, s, META)
            with dryrun.MetaRun(exclude=step.argument_tensors()) as run:
                step.fn()
            got[by_count] = (run.flops, run.peak, len(steps))
        (f1, p1, n1), (f0, p0, n0) = got[True], got[False]
        assert (f1, p1) == (f0, p0) and f1 > 0
        assert n1 < n0 / 10          # the steps the loops really ran

    def test_xlstm_train_chunks_counted_from_one_step(self, monkeypatch):
        """A reduced xLSTM train cell (remat, 9 mLSTM chunks a block): its
        mLSTM chunk loop under autograd runs two chunks on meta, forward
        and backward, and gives the FLOPs and peak bytes of every chunk
        run one by one, exactly."""
        cfg = tconfigs.smoke_config("xlstm-1.3b", attention_impl="pallas",
                                    remat="full")
        s = dataclasses.replace(tconfigs.SHAPES["train_4k"], seq=72, batch=2)
        pol = resolve(cfg, MESH1, s.batch, s.kind, seq=s.seq)
        one_chunk = txlstm._mlstm_chunk
        got = {}
        for by_count in (True, False):
            monkeypatch.setattr(txlstm, "META_LOOP_BY_COUNT", by_count)
            chunks = []
            monkeypatch.setattr(txlstm, "_mlstm_chunk", lambda *a: (
                chunks.append(1), one_chunk(*a))[1])
            step = dryrun.build_step(cfg, pol, s, META)
            with dryrun.MetaRun(exclude=step.argument_tensors()) as run:
                step.fn()
            got[by_count] = (run.flops, run.peak, len(chunks))
        (f1, p1, n1), (f0, p0, n0) = got[True], got[False]
        assert (f1, p1) == (f0, p0) and f1 > 0
        # 7 blocks x 9 chunks, run forward, again under remat and once
        # more in the backward; by count 2 chunks each time
        assert n0 == 3 * 7 * 9 and n1 == 3 * 7 * 2

    def test_attention_counts_as_its_kernel(self):
        """The kernel's meta function: its output's bytes and the visible
        pairs' FLOPs, never the plain version's scores."""
        from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                             visible_pairs)
        q = torch.empty((2, 4096, 10, 256), device=META,
                        dtype=torch.bfloat16)
        k = torch.empty((2, 4096, 1, 256), device=META, dtype=torch.bfloat16)
        with dryrun.MetaRun(exclude=[q, k]) as run:
            out = flash_attention(q, k, k, causal=True, window=2048)
        assert out.shape == q.shape and out.device == META
        assert run.peak == q.numel() * 2
        pairs = sum(min(i + 1, 2048) for i in range(4096))
        assert visible_pairs(4096, 4096, True, 2048) == pairs
        assert run.flops == 4 * 2 * 10 * 256 * pairs


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (64, 64, True, 0), (48, 48, True, 16), (32, 96, True, 0),
    (64, 64, False, 0), (40, 300, True, 128), (50, 50, False, 8)])
def test_visible_pairs_counts_the_plain_mask(Sq, Skv, causal, window):
    from repro_torch.kernels.flash_attention.ops import visible_pairs
    from repro_torch.kernels.flash_attention.ref import _mask
    qi = torch.arange(Sq) + (Skv - Sq)
    want = int(_mask(qi, torch.arange(Skv), causal, window).sum())
    assert visible_pairs(Sq, Skv, causal, window) == want


def reference_params(ref, family, jc, seed):
    jpol = ref.policy.single_device_policy(jc)
    init = ref.jax.jit(lambda key: ref.layers.unbox(
        family.init_params(jc, jpol, key))[0])
    return jpol, init(ref.jax.random.PRNGKey(seed))


def close(got, want, label):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, label
    bound = STEP_RTOL * np.abs(want) + STEP_RTOL * np.abs(want).max()
    excess = np.abs(got - want) - bound
    assert excess.max() <= 0, f"{label}: exceeds the bound by {excess.max()}"


@pytest.mark.parametrize("arch,seq", [("recurrentgemma-2b", 40),
                                      ("xlstm-1.3b", 40)])
def test_decode_from_a_filled_cache_matches_the_reference(ref, arch, seq):
    """One decode step at position seq - 1 (the hybrid's ring of 16 slots
    has wrapped twice) from a cache of seeded draws, the same cache on
    both sides: logits and every cache tensor within 1e-5."""
    family = {"recurrentgemma-2b": ref.hybrid, "xlstm-1.3b": ref.xlstm}[arch]
    jc = ref.configs.smoke_config(arch)
    jpol, jp = reference_params(ref, family, jc, seed=3)
    tc = tconfigs.smoke_config(arch)
    tpol = single_device_policy(tc)
    tp = params_from_jax(tc, ref.jax.tree.map(np.asarray, jp), device="cpu")
    B = 2
    gen = torch.Generator().manual_seed(5)
    tcache = dryrun.filled_cache(tc, tpol, B, seq, gen, "cpu")
    assert tcache.pos == seq - 1
    jcache = family.init_cache(jc, jpol, B, seq)
    jcache = jcache._replace(pos=ref.jnp.int32(seq - 1), **{
        f: ref.jnp.asarray(getattr(tcache, f).float().numpy()).astype(
            getattr(jcache, f).dtype)
        for f in jcache._fields if f != "pos"})
    toks = np.random.default_rng(7).integers(0, 251, (B, 1)).astype(
        np.int32)
    jl, jnew = family.decode_step(jc, jpol, jp, jcache, toks)
    with torch.inference_mode():
        tl, tnew = make_decode_logits_step(tc, tpol)(
            tp, tcache, torch.from_numpy(toks))
    close(tl[..., :tc.vocab_size], np.asarray(jl)[..., :jc.vocab_size],
          "logits")
    assert tnew.pos == int(jnew.pos) == seq
    for f in jcache._fields:
        if f != "pos":
            close(getattr(tnew, f).float(), getattr(jnew, f), f"cache.{f}")


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b",
                                  "seamless-m4t-large-v2", "granite-3-2b"])
def test_cache_rows_drawn_alone_are_the_whole_draws(arch):
    """Every (cache tensor, layer, batch row) slice has a seed of its own:
    rows drawn alone (a one-card reference's) are those rows of the whole
    draw, bitwise, and a mesh rank's shard of a tensor
    (`dryrun.draw_rows` with its offsets) is that part of it."""
    cfg = tconfigs.smoke_config(arch)
    pol = single_device_policy(cfg)
    whole = dryrun.filled_cache(cfg, pol, 5, 20,
                                torch.Generator().manual_seed(4), "cpu")
    for rows in ([0], [4], [1, 3]):
        alone = dryrun.filled_cache(cfg, pol, 5, 20,
                                    torch.Generator().manual_seed(4), "cpu",
                                    rows=rows)
        assert alone.pos == whole.pos == 19
        for a, w in zip(dryrun.tensors_of(alone), dryrun.tensors_of(whole)):
            assert a.dtype == w.dtype and torch.equal(a, w[:, rows])
    for leaf, w in enumerate(dryrun.tensors_of(whole)):
        part = torch.empty((w.shape[0], 2) + tuple(
            (n + 1) // 2 for n in w.shape[2:]), dtype=w.dtype)
        offs = [n // 2 for n in w.shape[2:]]
        dryrun.draw_rows(part, leaf, 4, [2, 3], offs, w.shape[2:])
        want = w[:, 2:4][(slice(None), slice(None)) + tuple(
            slice(o, o + k) for o, k in zip(offs, part.shape[2:]))]
        assert torch.equal(part[(slice(None), slice(None)) + tuple(
            slice(0, k) for k in want.shape[2:])], want)


def test_filled_cache_is_seeded():
    cfg = tconfigs.smoke_config("recurrentgemma-2b")
    pol = single_device_policy(cfg)
    a, b = (dryrun.filled_cache(cfg, pol, 2, 20,
                                torch.Generator().manual_seed(1), "cpu")
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(dryrun.tensors_of(a),
                                                 dryrun.tensors_of(b)))
    assert float(a.k.float().abs().sum()) > 0


def test_run_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dryrun.main(["--cells", "recurrentgemma-2b:long_500k", "--run"])
    cfg = tconfigs.smoke_config("recurrentgemma-2b")
    with pytest.raises(RuntimeError, match="measures the card"):
        dryrun.run_cell(cfg, single_device_policy(cfg),
                        tconfigs.SHAPES["long_500k"], device="cpu")


@pytest.mark.parametrize("conf,on", [
    ("", False), ("expandable_segments:True", True),
    ("max_split_size_mb:128, expandable_segments:true", True),
    ("expandable_segments:False,max_split_size_mb:128", False)])
def test_run_reads_the_callers_allocator_setting(monkeypatch, conf, on):
    """`expandable_segments` puts back the setting it found, read from the
    allocator's settings string."""
    monkeypatch.setattr(torch._C, "_accelerator_getAllocatorSettings",
                        lambda: conf, raising=False)
    assert dryrun._expandable_segments_on() is on


def test_run_reads_the_environment_where_torch_cannot_say(monkeypatch):
    monkeypatch.delattr(torch._C, "_accelerator_getAllocatorSettings",
                        raising=False)
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    monkeypatch.setenv("PYTORCH_ALLOC_CONF", "expandable_segments:True")
    assert dryrun._expandable_segments_on()
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:False")
    assert not dryrun._expandable_segments_on()


def test_command_line_writes_its_records(tmp_path, capsys):
    out = tmp_path / "dry.json"
    recs = dryrun.main(["--cells", "recurrentgemma-2b:long_500k,"
                        "xlstm-1.3b:long_500k", "--both-meshes",
                        "--out", str(out)])
    assert [(r["arch"], r["mesh"]) for r in recs] == [
        ("recurrentgemma-2b", "16x16"), ("recurrentgemma-2b", "2x16x16"),
        ("xlstm-1.3b", "16x16"), ("xlstm-1.3b", "2x16x16")]
    assert all(r["ok"] and r["fits_one_card"] for r in recs)
    assert out.is_file() and "4/4 cells built on meta, 4 fit one card" in \
        capsys.readouterr().out
