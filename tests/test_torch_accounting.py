"""The port's parameter and FLOP accounting (``repro_torch.models.
accounting``) against the JAX package's (``repro.models.accounting``): every
function for all ten architectures and every shape of ``shapes_for``.
Integers are exact, floats equal to rel 1e-12.  Then the port's twins of
``tests/test_dryrun_units.py``'s accounting tests.  Host arithmetic on
shapes only (no weight is made): a few seconds."""

import os

import pytest

pytest.importorskip("torch")

import repro.models.accounting as racc
from repro.configs import ARCHS as REF_ARCHS
from repro.models import shapes_for as ref_shapes_for

import repro_torch.models.accounting as acc
from repro_torch.configs import ARCHS
from repro_torch.models import DECODE_32K, TRAIN_4K, shapes_for

ARCH_NAMES = sorted(ARCHS)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
REL = 1e-12


def cells():
    return [(a, s.name) for a in ARCH_NAMES for s in shapes_for(ARCHS[a])]


def shape_pair(arch, name):
    (port,) = [s for s in shapes_for(ARCHS[arch]) if s.name == name]
    (ref,) = [s for s in ref_shapes_for(REF_ARCHS[arch]) if s.name == name]
    return port, ref


def test_registries_and_shapes_agree():
    assert sorted(REF_ARCHS) == ARCH_NAMES
    for arch in ARCH_NAMES:
        assert [s.name for s in shapes_for(ARCHS[arch])] == \
            [s.name for s in ref_shapes_for(REF_ARCHS[arch])]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_parameter_counts_equal_the_reference(arch):
    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    assert acc.total_params(cfg) == racc.total_params(rcfg)
    assert acc.active_params(cfg) == racc.active_params(rcfg)
    assert acc._attn_params(cfg) == racc._attn_params(rcfg)
    assert acc._ffn_params(cfg, cfg.d_ff) == racc._ffn_params(rcfg,
                                                             rcfg.d_ff)
    if cfg.moe:
        assert acc._ffn_params(cfg, cfg.moe.d_ff_expert) == \
            racc._ffn_params(rcfg, rcfg.moe.d_ff_expert)
    if cfg.ssm:
        assert acc._mamba_params(cfg) == racc._mamba_params(rcfg)
    assert acc._n_attn_applications(cfg) == racc._n_attn_applications(rcfg)


@pytest.mark.parametrize("arch,shape", cells())
def test_model_flops_equal_the_reference(arch, shape):
    port, ref = shape_pair(arch, shape)
    got = acc.model_flops(ARCHS[arch], port)
    want = racc.model_flops(REF_ARCHS[arch], ref)
    assert got == want
    assert all(isinstance(v, int) for v in got.values())


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_local_param_bytes_equal_the_reference(arch, mesh, mode):
    sizes = MESHES[mesh]
    for dtype_bytes in (2, 4):
        got = acc.local_param_bytes(ARCHS[arch], sizes, mode=mode,
                                    dtype_bytes=dtype_bytes)
        want = racc.local_param_bytes(REF_ARCHS[arch], sizes, mode=mode,
                                      dtype_bytes=dtype_bytes)
        assert got == pytest.approx(want, rel=REL, abs=0)
    # the default is the reference's bf16
    assert acc.local_param_bytes(ARCHS[arch], sizes, mode=mode) == \
        pytest.approx(racc.local_param_bytes(REF_ARCHS[arch], sizes,
                                             mode=mode), rel=REL, abs=0)


@pytest.mark.parametrize("arch,shape", cells())
def test_hbm_bytes_estimate_equals_the_reference(arch, shape):
    port, ref = shape_pair(arch, shape)
    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    for n_devices, model_shards in ((256, 16), (512, 16), (1, 1)):
        for accum in (1, 8):
            for w_local in (None, 1.5e9):
                got = acc.hbm_bytes_estimate(
                    cfg, port, n_devices, model_shards=model_shards,
                    accum=accum, w_local=w_local)
                want = racc.hbm_bytes_estimate(
                    rcfg, ref, n_devices, model_shards=model_shards,
                    accum=accum, w_local=w_local)
                assert got == pytest.approx(want, rel=REL, abs=0)
    assert acc.hbm_bytes_estimate(cfg, port, 256) == pytest.approx(
        racc.hbm_bytes_estimate(rcfg, ref, 256), rel=REL, abs=0)


def test_no_tpu_rate_constants():
    """The reference's v5e peak and bandwidth constants are TPU numbers
    that nothing reads: the port leaves them out."""
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        assert hasattr(racc, name) and not hasattr(acc, name)


# -- the port's twins of tests/test_dryrun_units.py ----------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_accounting_sane(arch):
    cfg = ARCHS[arch]
    n_tot = acc.total_params(cfg)
    n_act = acc.active_params(cfg)
    if cfg.attn_every:  # weight-tied shared block: active counts each apply
        assert 0 < n_act <= n_tot * 1.6
    else:
        assert 0 < n_act <= n_tot * 1.05  # unembed-vs-embed rounding slack
    if cfg.moe:
        assert n_act < n_tot * 0.5  # MoE: most params inactive
    expect = {"yi-34b": 34e9, "granite-20b": 20e9, "falcon-mamba-7b": 7e9,
              "zamba2-2.7b": 2.7e9, "qwen2-0.5b": 0.5e9,
              "llama4-maverick-400b-a17b": 400e9}.get(arch)
    if expect:
        assert 0.5 * expect < n_tot < 2.2 * expect, (arch, n_tot)


def test_llama4_active_matches_a17b():
    n_act = acc.active_params(ARCHS["llama4-maverick-400b-a17b"])
    assert 10e9 < n_act < 25e9  # "a17b"


def test_model_flops_scaling():
    cfg = ARCHS["yi-34b"]
    tr = acc.model_flops(cfg, TRAIN_4K)
    de = acc.model_flops(cfg, DECODE_32K)
    # train: 6·N·D with D=1M tokens
    assert tr["model_flops"] > 6 * 30e9 * 1e6 * 0.8
    # decode: 2·N per token x 128 slots
    assert de["model_flops"] < tr["model_flops"] / 1000
    assert de["tokens"] == 128


@pytest.fixture
def reference_dryrun():
    """The reference's dry-run module, imported with JAX's backend up first
    and ``XLA_FLAGS`` restored: its import sets 512 forced host devices,
    which must not reach a JAX that starts later in this worker."""
    import jax

    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as rdr
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return rdr


def test_accum_heuristic(reference_dryrun):
    from repro_torch.launch import dryrun as dr

    assert dr._accum_for(ARCHS["qwen2-0.5b"]) == 1
    assert dr._accum_for(ARCHS["yi-34b"]) == 8
    assert dr._accum_for(ARCHS["zamba2-2.7b"]) == 4
    for arch in ARCH_NAMES:
        assert dr._accum_for(ARCHS[arch]) == \
            reference_dryrun._accum_for(REF_ARCHS[arch])
