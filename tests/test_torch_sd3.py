"""The port's SD3 MMDiT and SD3Pipeline (``pygpukit_tpu_torch.diffusion``)
against the JAX package's on the same seeded inputs, on the CPU, at the
reference test's tiny sizes (tests/test_sd3.py, every one of whose tests
has its port here): the key layout, the forward (with SD3.5's per-stream
q/k norms), one joint block against a torch transcription of the diffusers
block, the prompt encoding and the guided flow-matching loop with the
reference's ``jax.random`` latents fed. The reference's random flat state
dicts (numpy) feed the port's ``params_from_state_dict``. f32 at rtol 1e-4
(atol 1e-5; the loop's atol 5e-5 of its largest |value|, the reference's
XLA CPU noise as tests/test_torch_diffusion.py states)."""

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pygpukit_tpu.diffusion import SD3Pipeline as RefSD3Pipeline  # noqa: E402
from pygpukit_tpu.diffusion.models import sd3 as ref_sd3  # noqa: E402
from pygpukit_tpu_torch.diffusion import SD3Pipeline  # noqa: E402
from pygpukit_tpu_torch.diffusion.models.sd3 import (SD3Config, SD3Transformer,  # noqa: E402
                                                     init_random_flat, params_from_state_dict,
                                                     sd3_forward_fn, state_dict_spec)
from pygpukit_tpu_torch.llm.safetensors import save_safetensors  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
CPU = "cpu"
TINY = dict(sample_size=8, patch_size=2, in_channels=4, out_channels=4, hidden_size=32,
            depth=3, num_heads=4, context_dim=16, pooled_dim=12, pos_embed_max_size=8)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


def _rng_f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flat(cfg: dict, seed: int, bias_seed: int | None = None) -> dict:
    """The reference's random flat state dict (numpy), biases given values
    when ``bias_seed`` is set (so transposes cannot hide)."""
    flat = ref_sd3.init_random_flat(ref_sd3.SD3Config(**cfg), seed=seed)
    if bias_seed is not None:
        rng = np.random.default_rng(bias_seed)
        for k in flat:
            if k.endswith("bias"):
                flat[k] = rng.standard_normal(flat[k].shape).astype(np.float32) * 0.05
    return flat


def _pair(cfg: dict, flat: dict):
    return (ref_sd3.SD3Transformer.from_state_dict(flat, ref_sd3.SD3Config(**cfg)),
            SD3Transformer.from_state_dict(flat, SD3Config(**cfg)))


class TestSpec:
    def test_spec_loader_roundtrip(self):
        flat = init_random_flat(SD3Config(**TINY), seed=0, device=CPU)
        assert len(flat) == len(state_dict_spec(SD3Config(**TINY)))
        p = params_from_state_dict(flat, SD3Config(**TINY))
        assert len(p["blocks"]) == 3
        assert "ao.w" in p["blocks"][0] and "ao.w" not in p["blocks"][2]

    def test_real_dims(self):
        spec = state_dict_spec(SD3Config())
        assert spec == ref_sd3.state_dict_spec(ref_sd3.SD3Config())
        assert spec["context_embedder.weight"] == (1536, 4096)
        assert spec["pos_embed.pos_embed"] == (1, 192 * 192, 1536)
        assert spec["transformer_blocks.23.norm1_context.linear.weight"] == (2 * 1536, 1536)
        assert spec["transformer_blocks.0.norm1_context.linear.weight"] == (6 * 1536, 1536)

    def test_params_bitwise_the_references(self):
        """The reference's flat dict through both loaders: every leaf the
        same bits (projections transposed to [in, out])."""
        flat = _flat(dict(TINY, qk_norm=True), 1, bias_seed=2)
        cfg = dict(TINY, qk_norm=True)
        want = jax.tree.map(np.asarray, ref_sd3.params_from_state_dict(
            flat, ref_sd3.SD3Config(**cfg)))
        got = params_from_state_dict(flat, SD3Config(**cfg))
        assert set(got) == set(want) and len(got["blocks"]) == len(want["blocks"])
        for g, w in zip([got] + got["blocks"], [want] + want["blocks"]):
            for k, v in w.items():
                if k != "blocks":
                    assert np.array_equal(g[k].numpy(), v), k

    def test_qk_norm_variant(self):
        cfg = dict(TINY, depth=2, qk_norm=True)
        flat = init_random_flat(SD3Config(**cfg), seed=0, device=CPU)
        assert "transformer_blocks.0.attn.norm_q.weight" in flat
        m = SD3Transformer.from_state_dict(flat, SD3Config(**cfg))
        out = m(torch.zeros((4, 8, 8)), 500.0, torch.zeros((5, 16)), torch.zeros(12))
        assert out.shape == (4, 8, 8)


class TestForward:
    def test_forward_shapes(self):
        m = SD3Transformer.init_random(SD3Config(**TINY), seed=0, device=CPU)
        out = m(_rng_f32(0, 4, 8, 8), 300.0, _rng_f32(1, 6, 16), _rng_f32(2, 12))
        assert out.shape == (4, 8, 8) and torch.isfinite(out).all()

    @pytest.mark.parametrize("qk_norm", [False, True])
    @pytest.mark.parametrize("hw", [(8, 8), (4, 6)])
    def test_forward_matches_the_reference(self, qk_norm, hw):
        """Both packages on one flat dict: the patch conv in f32, the
        cropped position table (a latent smaller than the table, off
        square), the joint blocks, the last block's continuous norm."""
        cfg = dict(TINY, qk_norm=qk_norm)
        flat = _flat(cfg, 3, bias_seed=4)
        if qk_norm:
            rng = np.random.default_rng(5)
            for k in flat:
                if "norm_" in k:
                    flat[k] = (1 + 0.3 * rng.standard_normal(flat[k].shape)).astype(np.float32)
        ref, ours = _pair(cfg, flat)
        lat, ctx, pooled = _rng_f32(6, 4, *hw), _rng_f32(7, 5, 16), _rng_f32(8, 12)
        want = ref(jnp.asarray(lat), 640.0, jnp.asarray(ctx), jnp.asarray(pooled))
        _close(ours(lat, 640.0, ctx, pooled), want)

    def test_joint_block_parity_vs_torch(self):
        """One non-last MMDiT joint block of the port (``_joint_attn`` and
        the block's body as ``sd3_forward_fn`` runs it) against a torch
        transcription of the diffusers JointTransformerBlock with the raw
        checkpoint tensors."""
        rng = np.random.default_rng(7)
        cfg = SD3Config(**TINY)
        flat = _flat(TINY, 7, bias_seed=8)
        hid, heads = cfg.hidden_size, cfg.num_heads
        d = hid // heads
        x = rng.standard_normal((10, hid)).astype(np.float32)
        ctx = rng.standard_normal((5, hid)).astype(np.float32)
        temb = rng.standard_normal((hid,)).astype(np.float32)
        from pygpukit_tpu_torch.diffusion._common import gelu_tanh, linear, ln
        from pygpukit_tpu_torch.diffusion.models.sd3 import _joint_attn
        lp = params_from_state_dict(flat, cfg)["blocks"][0]
        tt = torch.from_numpy(temb)
        sh1, sc1, g1, sh2, sc2, g2 = linear(lp, "mod", tt).chunk(6)
        csh1, csc1, cg1, csh2, csc2, cg2 = linear(lp, "cmod", tt).chunk(6)
        xj, cj = torch.from_numpy(x), torch.from_numpy(ctx)
        img_o, ctx_o = _joint_attn(cfg, lp, ln(xj) * (1 + sc1) + sh1,
                                   ln(cj) * (1 + csc1) + csh1, False)
        xj = xj + g1 * img_o
        xj = xj + g2 * linear(lp, "ff.out", gelu_tanh(linear(lp, "ff.in",
                                                             ln(xj) * (1 + sc2) + sh2)))
        cj = cj + cg1 * ctx_o
        cj = cj + cg2 * linear(lp, "cff.out", gelu_tanh(linear(lp, "cff.in",
                                                               ln(cj) * (1 + csc2) + csh2)))

        def T(name):
            return torch.tensor(flat[f"transformer_blocks.0.{name}"])

        def tlin(src, name):
            return torch.nn.functional.linear(src, T(f"{name}.weight"), T(f"{name}.bias"))
        lnt = torch.nn.LayerNorm(hid, eps=1e-6, elementwise_affine=False)
        xt, ct = torch.tensor(x), torch.tensor(ctx)
        m6, c6 = tlin(tt, "norm1.linear").chunk(6), tlin(tt, "norm1_context.linear").chunk(6)
        xh_t, ch_t = lnt(xt) * (1 + m6[1]) + m6[0], lnt(ct) * (1 + c6[1]) + c6[0]

        def tproj(src, name):
            return tlin(src, f"attn.{name}").reshape(-1, heads, d).transpose(0, 1)
        qt = torch.cat([tproj(ch_t, "add_q_proj"), tproj(xh_t, "to_q")], 1)
        kt = torch.cat([tproj(ch_t, "add_k_proj"), tproj(xh_t, "to_k")], 1)
        vt = torch.cat([tproj(ch_t, "add_v_proj"), tproj(xh_t, "to_v")], 1)
        ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        ot = ot.transpose(0, 1).reshape(-1, hid)
        xt = xt + m6[2] * tlin(ot[5:], "attn.to_out.0")
        h_t = lnt(xt) * (1 + m6[4]) + m6[3]
        xt = xt + m6[5] * tlin(torch.nn.functional.gelu(
            tlin(h_t, "ff.net.0.proj"), approximate="tanh"), "ff.net.2")
        ct = ct + c6[2] * tlin(ot[:5], "attn.to_add_out")
        hc_t = lnt(ct) * (1 + c6[4]) + c6[3]
        ct = ct + c6[5] * tlin(torch.nn.functional.gelu(
            tlin(hc_t, "ff_context.net.0.proj"), approximate="tanh"), "ff_context.net.2")
        _close(xj, xt.numpy())
        _close(cj, ct.numpy())


class TestQKNormStreams:
    def test_per_stream_qk_norms_loaded_and_distinct(self):
        """SD3.5: norm_q / norm_k act on the image stream, norm_added_q /
        norm_added_k on the context stream; scaling only norm_added_k moves
        the output (context keys shape the image queries' attention even in
        the last block), in the port as in the reference."""
        cfg = dict(TINY, depth=1, qk_norm=True)
        flat = _flat(cfg, 0)
        lat, ctxe, pooled = _rng_f32(0, 4, 8, 8), _rng_f32(1, 5, 16), _rng_f32(2, 12)
        ref, ours = _pair(cfg, flat)
        base = ours(lat, 100.0, ctxe, pooled)
        _close(base, ref(jnp.asarray(lat), 100.0, jnp.asarray(ctxe), jnp.asarray(pooled)))
        flat2 = dict(flat)
        flat2["transformer_blocks.0.attn.norm_added_k.weight"] = (
            flat["transformer_blocks.0.attn.norm_added_k.weight"] * 3.0)
        ref2, ours2 = _pair(cfg, flat2)
        changed = ours2(lat, 100.0, ctxe, pooled)
        assert not torch.allclose(base, changed)
        _close(changed, ref2(jnp.asarray(lat), 100.0, jnp.asarray(ctxe), jnp.asarray(pooled)))


def _stub_clip(dim, seed):
    """A duck-typed encoder (ids -> (hidden, pooled)), deterministic in the
    ids, numpy-backed so both packages get the same values."""
    def enc(ids):
        rng = np.random.default_rng(seed + int(np.sum(ids)))
        h = rng.standard_normal((len(ids), dim)).astype(np.float32)
        return h, h[-1]
    return enc


def _pipes(cfg: dict, seed: int = 0):
    flat = _flat(cfg, seed, bias_seed=seed + 1)
    ref, ours = _pair(cfg, flat)
    encs = [_stub_clip(16, 1), _stub_clip(32, 2)]
    toks = [lambda p, **kw: {"input_ids": [1, 2, 3] + [len(p)] * 74}] * 2
    rp = RefSD3Pipeline(ref, clip_encoders=encs)
    rp.clip_tokenizers = toks

    def wrap(enc):
        def port_enc(ids):
            h, pl = enc(ids)
            return torch.from_numpy(h), torch.from_numpy(np.ascontiguousarray(pl))
        return port_enc
    op = SD3Pipeline(ours, clip_encoders=[wrap(e) for e in encs])
    op.clip_tokenizers = toks
    return rp, op


class TestPromptEncoding:
    def test_encode_prompt_shapes(self):
        """CLIP-L/G (stub encoders and tokenizers) per the diffusers SD3
        recipe: concatenated on features, padded to the context width."""
        cfg = dict(TINY, depth=1, context_dim=64, pooled_dim=48)
        rp, op = _pipes(cfg)
        ctxe, pooled = op.encode_prompt("hello")
        assert ctxe.shape == (77, 64) and pooled.shape == (48,)
        want = rp.encode_prompt("hello")
        _close(ctxe, want[0])
        _close(pooled, want[1])
        lat = op.generate(prompt="hello", num_steps=2, guidance_scale=1.0)
        assert tuple(lat.shape) == (4, 8, 8)

    @pytest.mark.parametrize("guidance,steps", [(1.0, 2), (7.0, 4)])
    def test_generate_matches_the_reference_with_its_draw(self, guidance, steps):
        """The guided flow-matching loop (shift 3) from a prompt, the
        negative prompt "" through the same encoders, the reference's
        jax.random latents fed."""
        cfg = dict(TINY, depth=2, context_dim=64, pooled_dim=48)
        rp, op = _pipes(cfg, 3)
        want = np.asarray(rp.generate(prompt="a cat", num_steps=steps,
                                      guidance_scale=guidance, seed=5))
        lat = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (4, 8, 8), jnp.float32))
        got = op.generate(prompt="a cat", num_steps=steps, guidance_scale=guidance,
                          latents=lat)
        _close(got, want, atol=5e-5 * float(np.abs(want).max()))
        again = op.generate(prompt="a cat", num_steps=steps, guidance_scale=guidance,
                            latents=lat)
        assert torch.equal(got, again)


class TestCheckpoint:
    def test_safetensors_round_trip(self, tmp_path):
        """A flat dict written with the diffusers names and read back by
        from_safetensors: every leaf as from_state_dict gives it."""
        cfg = SD3Config(**dict(TINY, qk_norm=True))
        flat = init_random_flat(cfg, seed=9, device=CPU)
        save_safetensors(tmp_path / "diffusion_pytorch_model.safetensors", flat)
        got = SD3Transformer.from_safetensors(tmp_path, cfg, device=CPU)
        want = params_from_state_dict(flat, cfg)
        for g, w in zip([got.params] + got.params["blocks"], [want] + want["blocks"]):
            assert all(torch.equal(g[k], v) for k, v in w.items() if k != "blocks")
        lat = _rng_f32(1, 4, 8, 8)
        assert torch.equal(got(lat, 10.0, _rng_f32(2, 3, 16), _rng_f32(3, 12)),
                           sd3_forward_fn(cfg, want, torch.from_numpy(lat),
                                          torch.tensor(10.0), torch.from_numpy(
                                              _rng_f32(2, 3, 16)),
                                          torch.from_numpy(_rng_f32(3, 12))))
