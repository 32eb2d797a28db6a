"""The port's PixArt-alpha transformer and PixArtPipeline
(``pygpukit_tpu_torch.diffusion``) against the JAX package's on the same
seeded inputs, on the CPU, at the reference test's tiny sizes
(tests/test_pixart.py, every one of whose tests has its port here): the key
layout, the sin-cos position table bit for bit, the forward with and
without the 1024 checkpoints' size conditioning, one block against a torch
transcription of the diffusers block, the DDIM loop with guidance with the
reference's ``jax.random`` latents fed, and ``from_safetensors`` with its
config.json. f32 at rtol 1e-4 (atol 1e-5; the loop's atol 5e-5 of its
largest |value|, the reference's XLA CPU noise as
tests/test_torch_diffusion.py states)."""

import json

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pygpukit_tpu.diffusion import PixArtPipeline as RefPixArtPipeline  # noqa: E402
from pygpukit_tpu.diffusion.models import pixart as ref_pixart  # noqa: E402
from pygpukit_tpu_torch.diffusion import PixArtPipeline  # noqa: E402
from pygpukit_tpu_torch.diffusion.models import pixart  # noqa: E402
from pygpukit_tpu_torch.diffusion.models.pixart import (PixArtConfig,  # noqa: E402
                                                        PixArtTransformer, init_random_flat,
                                                        params_from_state_dict,
                                                        pixart_forward_fn, state_dict_spec)
from pygpukit_tpu_torch.llm.safetensors import save_safetensors  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
CPU = "cpu"
TINY = dict(sample_size=8, patch_size=2, in_channels=4, out_channels=8, hidden_size=32,
            depth=2, num_heads=4, caption_dim=16, base_size=4)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


def _rng_f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flat(cfg: dict, seed: int, bias_seed: int | None = None) -> dict:
    flat = ref_pixart.init_random_flat(ref_pixart.PixArtConfig(**cfg), seed=seed)
    if bias_seed is not None:
        rng = np.random.default_rng(bias_seed)
        for k in flat:
            if k.endswith("bias"):
                flat[k] = rng.standard_normal(flat[k].shape).astype(np.float32) * 0.05
    return flat


def _pair(cfg: dict, flat: dict):
    return (ref_pixart.PixArtTransformer.from_state_dict(flat, ref_pixart.PixArtConfig(**cfg)),
            PixArtTransformer.from_state_dict(flat, PixArtConfig(**cfg)))


class TestSpec:
    def test_spec_loader_roundtrip(self):
        flat = init_random_flat(PixArtConfig(**TINY), seed=0, device=CPU)
        assert len(flat) == len(state_dict_spec(PixArtConfig(**TINY)))
        p = params_from_state_dict(flat, PixArtConfig(**TINY))
        assert p["blocks"]["attn1.q.w"].shape == (2, 32, 32)

    def test_real_dims_spec(self):
        spec = state_dict_spec(PixArtConfig())
        assert spec == ref_pixart.state_dict_spec(ref_pixart.PixArtConfig())
        assert spec["transformer_blocks.27.ff.net.0.proj.weight"] == (4608, 1152)
        assert spec["caption_projection.linear_1.weight"] == (1152, 4096)
        assert spec["proj_out.weight"] == (32, 1152)

    @pytest.mark.parametrize("extra", [False, True])
    def test_params_bitwise_the_references(self, extra):
        """Every leaf of the reference's flat dict through both loaders the
        same bits, the sin-cos table (numpy, f64 then f32) included."""
        cfg = dict(TINY, use_additional_conditions=extra, hidden_size=48)
        flat = _flat(cfg, 1, bias_seed=2)
        want = jax.tree.map(np.asarray, ref_pixart.params_from_state_dict(
            flat, ref_pixart.PixArtConfig(**cfg)))
        got = params_from_state_dict(flat, PixArtConfig(**cfg))
        assert set(got) == set(want) and set(got["blocks"]) == set(want["blocks"])
        for k in want:
            tree_g = got[k] if k == "blocks" else {k: got[k]}
            tree_w = want[k] if k == "blocks" else {k: want[k]}
            for kk in tree_w:
                assert np.array_equal(tree_g[kk].numpy(), tree_w[kk]), (k, kk)


class TestForward:
    def test_forward_shapes(self):
        m = PixArtTransformer.init_random(PixArtConfig(**TINY), seed=0, device=CPU)
        out = m(_rng_f32(0, 4, 8, 8), 500.0, _rng_f32(1, 7, 16))
        assert out.shape == (8, 8, 8) and torch.isfinite(out).all()

    @pytest.mark.parametrize("hw", [(8, 8), (4, 4)])
    def test_forward_matches_the_reference(self, hw):
        flat = _flat(TINY, 3, bias_seed=4)
        ref, ours = _pair(TINY, flat)
        lat, cap = _rng_f32(5, 4, *hw), _rng_f32(6, 7, 16)
        _close(ours(lat, 321.0, cap), ref(jnp.asarray(lat), 321.0, jnp.asarray(cap)))

    def test_block_parity_vs_torch(self):
        """One ada_norm_single block of the port (the block body as
        ``pixart_forward_fn`` runs it) against a torch transcription of the
        diffusers BasicTransformerBlock with the raw checkpoint weights."""
        rng = np.random.default_rng(3)
        cfg = PixArtConfig(**TINY)
        flat = _flat(TINY, 3, bias_seed=3)
        p = params_from_state_dict(flat, cfg)
        hid, heads = cfg.hidden_size, cfg.num_heads
        x = rng.standard_normal((16, hid)).astype(np.float32)
        ctx = rng.standard_normal((5, hid)).astype(np.float32)
        cond6 = rng.standard_normal((6 * hid,)).astype(np.float32)
        from pygpukit_tpu_torch.diffusion._common import gelu_tanh, layer, linear, ln
        lp = layer(p["blocks"], 0)
        mod = lp["scale_shift_table"] + torch.from_numpy(cond6).reshape(6, -1)
        sh1, sc1, g1, sh2, sc2, g2 = mod
        xj = torch.from_numpy(x)
        h = ln(xj) * (1 + sc1) + sh1
        xj = xj + g1 * pixart._attn(h, h, lp, "attn1", heads)
        xj = xj + pixart._attn(xj, torch.from_numpy(ctx), lp, "attn2", heads)
        h = ln(xj) * (1 + sc2) + sh2
        xj = xj + g2 * linear(lp, "ff.out", gelu_tanh(linear(lp, "ff.in", h)))

        def T(name):
            return torch.tensor(flat[f"transformer_blocks.0.{name}"])

        def t_attn(q_in, kv_in, prefix):
            def proj(name, src):
                return torch.nn.functional.linear(src, T(f"{prefix}.{name}.weight"),
                                                  T(f"{prefix}.{name}.bias"))
            q, k, v = (proj(n, s).reshape(-1, heads, hid // heads).transpose(0, 1)
                       for n, s in (("to_q", q_in), ("to_k", kv_in), ("to_v", kv_in)))
            o = torch.nn.functional.scaled_dot_product_attention(q, k, v)
            return torch.nn.functional.linear(o.transpose(0, 1).reshape(-1, hid),
                                              T(f"{prefix}.to_out.0.weight"),
                                              T(f"{prefix}.to_out.0.bias"))
        xt = torch.tensor(x)
        lnt = torch.nn.LayerNorm(hid, eps=1e-6, elementwise_affine=False)
        tsh1, tsc1, tg1, tsh2, tsc2, tg2 = T("scale_shift_table") + torch.tensor(
            cond6).reshape(6, -1)
        h_t = lnt(xt) * (1 + tsc1) + tsh1
        xt = xt + tg1 * t_attn(h_t, h_t, "attn1")
        xt = xt + t_attn(xt, torch.tensor(ctx), "attn2")
        h_t = lnt(xt) * (1 + tsc2) + tsh2
        ffh = torch.nn.functional.gelu(torch.nn.functional.linear(
            h_t, T("ff.net.0.proj.weight"), T("ff.net.0.proj.bias")), approximate="tanh")
        xt = xt + tg2 * torch.nn.functional.linear(ffh, T("ff.net.2.weight"), T("ff.net.2.bias"))
        _close(xj, xt.numpy())

    def test_patchify_unpatchify_inverse_layout(self):
        """The unit patch conv and an identity proj_out: unpatchify places
        each output where the reference places it (the forward with a zero
        position table, both packages)."""
        cfg = dict(sample_size=4, patch_size=2, in_channels=2, out_channels=2, hidden_size=8,
                   depth=1, num_heads=2, caption_dim=4, base_size=2)
        flat = ref_pixart.init_random_flat(ref_pixart.PixArtConfig(**cfg), seed=0, scale=0.0)
        w = np.zeros((8, 2, 2, 2), np.float32)
        wo = np.zeros((8, 8), np.float32)
        for c_ in range(2):
            for i in range(2):
                for j in range(2):
                    w[c_ * 4 + i * 2 + j, c_, i, j] = 1.0
                    wo[i * 2 * 2 + j * 2 + c_, c_ * 4 + i * 2 + j] = 1.0
        flat["pos_embed.proj.weight"], flat["proj_out.weight"] = w, wo
        p = params_from_state_dict(flat, PixArtConfig(**cfg))
        p["pos_embed"] = torch.zeros_like(p["pos_embed"])
        rp = ref_pixart.params_from_state_dict(flat, ref_pixart.PixArtConfig(**cfg))
        rp["pos_embed"] = jnp.zeros_like(rp["pos_embed"])
        lat = np.arange(2 * 4 * 4, dtype=np.float32).reshape(2, 4, 4)
        out = pixart_forward_fn(PixArtConfig(**cfg), p, torch.from_numpy(lat),
                                torch.tensor(0.0), torch.zeros((3, 4)))
        want = ref_pixart.pixart_forward_fn(ref_pixart.PixArtConfig(**cfg), rp,
                                            jnp.asarray(lat), jnp.float32(0.0),
                                            jnp.zeros((3, 4)))
        assert out.shape == (2, 4, 4) and torch.isfinite(out).all()
        _close(out, want)


class TestPipeline:
    def test_pixart_pipeline_latents(self):
        """The DDIM loop over the tiny transformer, no VAE or T5 (caption
        embeds given), latents out."""
        m = PixArtTransformer.init_random(PixArtConfig(**TINY), seed=0, device=CPU)
        lat = PixArtPipeline(m).generate(caption_embeds=_rng_f32(0, 6, 16), num_steps=3,
                                         guidance_scale=2.0, seed=1)
        assert tuple(lat.shape) == (4, 8, 8) and torch.isfinite(lat).all()

    @pytest.mark.parametrize("guidance,steps", [(1.0, 3), (4.5, 5)])
    def test_generate_matches_the_reference_with_its_draw(self, guidance, steps):
        """DDIM with guidance (zero unconditional embeds), the reference's
        jax.random latents fed; a second run bitwise."""
        flat = _flat(TINY, 4, bias_seed=5)
        ref, ours = _pair(TINY, flat)
        cap = _rng_f32(6, 6, 16)
        want = np.asarray(RefPixArtPipeline(ref).generate(
            caption_embeds=jnp.asarray(cap), num_steps=steps, guidance_scale=guidance, seed=2))
        lat = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (4, 8, 8), jnp.float32))
        pipe = PixArtPipeline(ours)
        got = pipe.generate(caption_embeds=cap, num_steps=steps, guidance_scale=guidance,
                            latents=lat)
        _close(got, want, atol=5e-5 * float(np.abs(want).max()))
        assert torch.equal(got, pipe.generate(caption_embeds=cap, num_steps=steps,
                                              guidance_scale=guidance, latents=lat))


class TestAdditionalConditions:
    def test_1024_spec_and_forward(self):
        cfg = dict(TINY, hidden_size=48, depth=1, use_additional_conditions=True)
        flat = init_random_flat(PixArtConfig(**cfg), seed=0, device=CPU)
        assert flat["adaln_single.emb.resolution_embedder.linear_1.weight"].shape == (16, 256)
        m = PixArtTransformer.from_state_dict(flat, PixArtConfig(**cfg))
        lat, cap = _rng_f32(0, 4, 8, 8), np.zeros((5, 16), np.float32)
        out = m(lat, 400.0, cap)
        assert out.shape == (8, 8, 8) and torch.isfinite(out).all()
        flat2 = dict(flat)
        flat2["adaln_single.emb.aspect_ratio_embedder.linear_2.bias"] = torch.ones(16)
        m2 = PixArtTransformer.from_state_dict(flat2, PixArtConfig(**cfg))
        assert not torch.allclose(out, m2(lat, 400.0, cap))

    @pytest.mark.parametrize("hw", [(8, 8), (6, 8)])
    def test_size_conditioning_matches_the_reference(self, hw):
        """The resolution and aspect-ratio embedders from the latent's
        shape (off square too) and given explicitly."""
        cfg = dict(TINY, hidden_size=48, depth=1, use_additional_conditions=True)
        flat = _flat(cfg, 6, bias_seed=7)
        ref, ours = _pair(cfg, flat)
        lat, cap = _rng_f32(8, 4, *hw), _rng_f32(9, 5, 16)
        _close(ours(lat, 250.0, cap), ref(jnp.asarray(lat), 250.0, jnp.asarray(cap)))
        want = ref_pixart.pixart_forward_fn(
            ref_pixart.PixArtConfig(**cfg), ref.params, jnp.asarray(lat), jnp.float32(250.0),
            jnp.asarray(cap), resolution=[1024.0, 768.0], aspect_ratio=[0.75])
        got = pixart_forward_fn(PixArtConfig(**cfg), ours.params, torch.from_numpy(lat),
                                torch.tensor(250.0), torch.from_numpy(cap),
                                resolution=[1024.0, 768.0], aspect_ratio=[0.75])
        _close(got, want)


class TestCheckpoint:
    def test_from_safetensors_reads_config_json(self, tmp_path):
        """transformer/ with config.json (a 1024-class config: the size
        conditioners on, base_size sample // patch): the dims as the
        reference reads them, every leaf the written value, the forward as
        the reference's on the same file."""
        hf = {"sample_size": 16, "patch_size": 2, "in_channels": 4, "out_channels": 8,
              "num_attention_heads": 4, "attention_head_dim": 12, "num_layers": 2,
              "caption_channels": 16, "use_additional_conditions": True}
        cfg = pixart.config_from_hf(hf)
        assert (cfg.hidden_size, cfg.base_size, cfg.use_additional_conditions) == (48, 8, True)
        flat = init_random_flat(cfg, seed=3, device=CPU)
        save_safetensors(tmp_path / "diffusion_pytorch_model.safetensors", flat)
        (tmp_path / "config.json").write_text(json.dumps(hf))
        got = PixArtTransformer.from_safetensors(tmp_path, device=CPU)
        assert got.config == cfg
        want = params_from_state_dict(flat, cfg)
        assert all(torch.equal(got.params[k], want[k]) for k in want if k != "blocks")
        assert all(torch.equal(got.params["blocks"][k], v) for k, v in want["blocks"].items())
        ref = ref_pixart.PixArtTransformer.from_safetensors(tmp_path)
        lat, cap = _rng_f32(1, 4, 16, 16), _rng_f32(2, 3, 16)
        _close(got(lat, 77.0, cap), ref(jnp.asarray(lat), 77.0, jnp.asarray(cap)))
