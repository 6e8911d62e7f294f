"""The MoE decoders' forward values beside serving, against the JAX
package on the weights of ``tests/test_torch_moe_serve.py`` (smoke
sizes): ``lm_train_loss`` with ``router_aux`` (and the trainer's
``make_loss_fn``, the same loss), qwen3's query/key norms on and off (the K each
cache holds is normed, then rotated), a bf16 forward with the share of
identical routing choices printed beside the logits bound, and the CLIs'
MoE flags.  Tolerances as in ``test_torch_moe_serve``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.amp import make_policy as jmake_policy
from repro.models import api as japi
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.core.amp import make_policy
from repro_torch.models import api
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from test_torch_moe_serve import (ARCHS, BF16_LOGIT_REL_L2, JPOL, LOGIT_TOL,
                                  POL, _model, _tokens)
import torch_threads  # noqa: F401  (one PyTorch thread a worker)


# ---------------------------------------------------------------------------
# the training loss's forward value
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moe_impl", ["dense", "a2a"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_loss_adds_the_router_aux(arch, moe_impl):
    """``lm_train_loss`` at two blocks on (2, 25) tokens: the loss
    (lm_loss + 0.01 aux), lm_loss and router_aux as the reference's
    (rtol 1e-5); ``aux_coef`` replaces the config's coefficient.  The
    trainer's loss function (``make_loss_fn``, on ``moe_impl``) is the
    same loss."""
    jcfg, cfg, jp, tp = _model(arch, 2)
    toks = _tokens(cfg, (2, 25), 3)
    jloss, jm = japi.lm_train_loss(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                   JPOL, moe_impl=moe_impl)
    loss, m = api.lm_train_loss(tp, {"tokens": torch.from_numpy(toks)}, cfg,
                                POL, moe_impl=moe_impl)
    for got, want in ((loss, jloss), (m["lm_loss"], jm["lm_loss"]),
                      (m["router_aux"], jm["router_aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(loss) == pytest.approx(
        float(m["lm_loss"]) + cfg.router_aux_coef * float(m["router_aux"]),
        rel=1e-6)
    loss2, _ = api.lm_train_loss(tp, {"tokens": torch.from_numpy(toks)},
                                 cfg, POL, moe_impl=moe_impl, aux_coef=1.0)
    jloss2, _ = japi.lm_train_loss(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                   JPOL, moe_impl=moe_impl, aux_coef=1.0)
    np.testing.assert_allclose(float(loss2), float(jloss2), rtol=1e-5)
    fn_loss, fn_m = api.make_loss_fn(cfg, POL, moe_impl=moe_impl)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(fn_loss, loss)
    assert torch.equal(fn_m["router_aux"], m["router_aux"])


# ---------------------------------------------------------------------------
# query/key norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qk_norm", [True, False])
def test_qk_norm_on_and_off(qk_norm):
    """qwen3 with its query/key norms and without them: the forward
    matches the reference's, and the K a contiguous, a paged and an int8
    paged cache hold after a prefill equal the reference's (normed, then
    rotated); with the norms a different forward than without."""
    jcfg, cfg, jp, tp = _model("qwen3-moe-30b-a3b", 1, qk_norm)
    toks = _tokens(cfg, (2, 12), 4)
    want, _ = JT.apply_lm(jp, jnp.asarray(toks), jcfg, JPOL,
                          moe_impl="dense")
    got = T.apply_lm(tp, torch.from_numpy(toks), cfg, POL, moe_impl="dense")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    _, ocfg, _, other = _model("qwen3-moe-30b-a3b", 1, not qk_norm)
    off = T.apply_lm(other, torch.from_numpy(toks), ocfg, POL,
                     moe_impl="dense")
    assert float((off - got).abs().max()) > 1e-2
    for quant in (None, False, True):
        jpaged = tpaged = None
        if quant is not None:
            jpaged = JT.PagedCacheConfig(page_size=4, num_pages=9,
                                         quantized=quant)
            tpaged = T.PagedCacheConfig(page_size=4, num_pages=9,
                                        quantized=quant)
        jstate = JT.init_decode_state(jcfg, 2, 16, jnp.float32, paged=jpaged)
        tstate = T.init_decode_state(cfg, 2, 16, torch.float32, paged=tpaged,
                                     device="cpu")
        if quant is not None:
            rows = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
            jstate = JT.set_block_tables(jstate, rows)
            T.set_block_tables(tstate, rows)
        _, jstate = JT.prefill(jp, jnp.asarray(toks), jcfg, JPOL,
                               state=jstate, moe_impl="dense")
        T.prefill(tp, torch.from_numpy(toks), cfg, POL, state=tstate,
                  moe_impl="dense")
        jc, tc = jstate["blocks"][0]["cache"], tstate["blocks"][0]["cache"]
        keys = {None: ("k",), False: ("k_pages",),
                True: ("k_pages", "k_scale")}[quant]
        for key in keys:
            np.testing.assert_allclose(
                tc[key].float().numpy(), np.asarray(jc[key][0], np.float32),
                rtol=1e-5, atol=1e-5 if key != "k_pages" or not quant else 1)


# ---------------------------------------------------------------------------
# bf16: the routing both packages choose
# ---------------------------------------------------------------------------

def _recording(mod, record):
    real = mod._router

    def router(params, xt, cfg, policy):
        out = real(params, xt, cfg, policy)
        record.append(np.asarray(out[1]))
        return out
    return real, router


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_and_routing_agreement(arch, capsys):
    """The bf16 policy at two blocks: logits of (2, 24) tokens within
    chip_smoke.py's bf16 bound (relative L2 5e-2) of the reference's, and
    the share of identical (token, layer, slot) routing choices, each
    package's router reading its own bf16 hidden state, printed beside it
    (a near tie may flip where the two round differently)."""
    jcfg, cfg, jp, tp = _model(arch, 2)
    toks = _tokens(cfg, (2, 24), 9)
    jrec, trec = [], []
    jreal, jrouter = _recording(JM, jrec)
    treal, trouter = _recording(M, trec)
    JM._router, M._router = jrouter, trouter
    try:
        with jax.disable_jit():
            want, _ = JT.apply_lm(jp, jnp.asarray(toks), jcfg,
                                  jmake_policy("bf16"), moe_impl="dense")
        got = T.apply_lm(tp, torch.from_numpy(toks), cfg,
                         make_policy("bf16"), moe_impl="dense")
    finally:
        JM._router, M._router = jreal, treal
    a, b = got.float().numpy(), np.asarray(want, np.float32)
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    assert len(trec) == len(jrec) == cfg.n_layers
    share = float(np.mean([np.mean(t == j) for t, j in zip(trec, jrec)]))
    with capsys.disabled():
        print(f"\n{arch} bf16 forward vs the reference: logits rel L2 "
              f"{rel:.3e} (bound {BF16_LOGIT_REL_L2}); identical routing "
              f"choices {share:.4f} of {sum(t.size for t in trec)}")
    assert rel <= BF16_LOGIT_REL_L2
    assert share > 0.9


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode,moe_impl", [
    ("granite-moe-3b-a800m", "continuous", "a2a"),
    ("qwen3-moe-30b-a3b", "raw", "dense")])
def test_serve_cli_runs_on_cpu(arch, mode, moe_impl, caplog):
    """``launch/serve.py --arch ... --moe-impl`` at the smoke size."""
    from repro_torch.launch import serve
    args = ["--device", "cpu", "--arch", arch, "--mode", mode,
            "--cache-mode", "paged", "--requests", "3", "--prompt-len", "16",
            "--new-tokens", "4", "--moe-impl", moe_impl]
    with caplog.at_level("INFO", logger="repro_torch.serve"):
        out = serve.main(args)
    text = caplog.text
    assert arch in text
    if mode == "raw":
        assert out.shape == (4, 4) and "generated ids" in text
    else:
        assert out.moe_impl == moe_impl and "3 requests done" in text


def test_profile_serve_and_train_take_or_refuse_the_moe_archs():
    """``profile_serve --arch`` parses both MoE configs with ``--layers``
    and ``--moe-impl`` and then asks for the card it measures; the trainer
    takes them: one finite, taken step of each with its router aux."""
    from repro_torch.launch import profile_serve, train
    for arch in ARCHS:
        with pytest.raises(SystemExit, match="no CUDA device"):
            profile_serve.main(["--arch", arch, "--full-width", "--layers",
                                "8", "--moe-impl", "a2a"])
        cfg, state, history = train.run(
            ["--arch", arch, "--device", "cpu", "--steps", "1", "--batch",
             "2", "--seq", "16"])
        assert cfg.has_moe and state.opt.step == 1
        assert [r["step"] for r in history] == [1]
        assert np.isfinite(history[0]["loss"]) and not history[0]["skipped"]
        assert np.isfinite(history[0]["router_aux"])
