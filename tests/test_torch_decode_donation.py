"""``decode_step(..., donate_cache=True)``, the counterpart of the
reference dry run's ``donate_argnums`` on the cache: in every family at
smoke size on the CPU, the donated step's logits and cache equal the
copying step's bit for bit, and the cache it returns holds the very
tensors it was given (their storage unchanged), but for a mamba window
whose dtype the step changes (a bf16 window comes back f32, as in the
reference; XLA leaves such a donated buffer unused).  Slots past the cache
or before it keep their rows, as the copying step's masked write keeps
them.  Without the keyword the step leaves its input cache as it was."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS
from repro_torch.models import decode_step, init_cache, init_model, smoke
from repro_torch.models.layers import attention_decode
from repro_torch.training.tree import tree_map, tree_paths

from torch_training_parity import one_thread  # noqa: F401  (fixture)

ARCH_NAMES = sorted(ARCHS)
B, S = 4, 16


def model(arch, cache_dtype, seed=0):
    cfg = smoke(ARCHS[arch])
    g = torch.Generator().manual_seed(seed)
    params = init_model(cfg, g, device="cpu")
    cache = init_cache(cfg, B, S, dtype=cache_dtype, device="cpu")
    cache = tree_map(lambda t: torch.randn(t.shape, generator=g).to(t.dtype),
                     cache)
    token = torch.randint(0, cfg.vocab, (B, 1), generator=g)
    return cfg, params, cache, token


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else \
        t.view(torch.int16)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_donated_step_equals_the_copying_step(arch, cache_dtype, one_thread):
    cfg, params, cache, token = model(arch, cache_dtype)
    # slots mid-cache, at its first and last row, past it and before it
    curs = [torch.tensor([3, 0, S - 1, S + 2]), 5,
            torch.tensor([-1, 7, S, 2])]
    for step, cur in enumerate(curs):
        with torch.no_grad():
            given = tree_paths(cache)
            ptrs = {k: t.data_ptr() for k, t in given.items()}
            want, want_cache = decode_step(params, cfg, token,
                                           tree_map(torch.clone, cache), cur)
            got, got_cache = decode_step(params, cfg, token, cache, cur,
                                         donate_cache=True)
        assert torch.equal(bits(got), bits(want))
        gp, wp = tree_paths(got_cache), tree_paths(want_cache)
        assert gp.keys() == wp.keys() == given.keys()
        for k in gp:
            assert gp[k].dtype == wp[k].dtype, k
            assert torch.equal(bits(gp[k]), bits(wp[k])), k
            changed = given[k].dtype != gp[k].dtype
            # only the first step from a bf16 cache changes a window's dtype
            assert changed == (step == 0 and cache_dtype == torch.bfloat16
                               and k.endswith("/conv")), k
            if not changed:
                assert gp[k] is given[k] and gp[k].data_ptr() == ptrs[k], k
        cache = got_cache


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b",
                                  "llama-3.2-vision-90b"])
def test_the_copying_step_leaves_its_cache_alone(arch, one_thread):
    cfg, params, cache, token = model(arch, torch.bfloat16, seed=1)
    before = tree_map(torch.clone, cache)
    with torch.no_grad():
        _, new = decode_step(params, cfg, token, cache, 2)
    for k, t in tree_paths(cache).items():
        assert torch.equal(bits(t), bits(tree_paths(before)[k]))
        if not k.endswith(("/xk", "/xv")):   # the memory passes through
            assert tree_paths(new)[k] is not t


def test_attention_decode_writes_one_row_a_slot_in_place(one_thread):
    cfg = smoke(ARCHS["yi-34b"])
    g = torch.Generator().manual_seed(2)
    p = init_model(cfg, g, device="cpu")["blocks"]["l0"]["attn"]
    p = tree_map(lambda t: t[0], p)
    x = torch.randn((B, 1, cfg.d_model), generator=g)
    k = torch.randn((B, S, cfg.n_kv_heads, cfg.d_head), generator=g)
    v = torch.randn((B, S, cfg.n_kv_heads, cfg.d_head), generator=g)
    cur = torch.tensor([0, 9, S, -2])
    want = attention_decode(p, cfg, x, k.clone(), v.clone(), cur)
    k0, v0 = k.clone(), v.clone()
    got = attention_decode(p, cfg, x, k, v, cur, donate=True)
    assert got[1] is k and got[2] is v
    for a, b in zip(got, want):
        assert torch.equal(bits(a), bits(b))
    changed = (k != k0).any(dim=(2, 3))
    assert changed.tolist() == [[i == c for i in range(S)]
                                for c in (0, 9, -1, -1)]
    assert torch.equal((v != v0).any(dim=(2, 3)), changed)
