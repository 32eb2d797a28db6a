"""The port's diffusion stack (``pygpukit_tpu_torch.diffusion``: the
schedulers, the VAE, CLIP and T5, DiT, FLUX and the FLUX pipeline with
img2img and inpainting) against the JAX package's on the same seeded
inputs, on the CPU, at the reference test's tiny sizes
(tests/test_diffusion.py, every one of whose tests has its port here).

The reference's random weights are carried into the port's tree by
``llm.convert.params_from_jax``, and its ``jax.random`` draws (latents,
img2img noise, the VAE posterior's sample) are fed to the port's entry
points as tensors. f32 is held at rtol 1e-4 (atol 1e-5), the schedules
and T5's relative buckets bit for bit, uint8 images within one level (an
f32 residue may flip a rounding boundary). FLUX's forwards and the
denoise loops take atol 5e-5 of the largest |value|: on the tiny
pipeline's forward the reference's XLA CPU result is 3.6e-5 from an f64
evaluation of the same function where the port's is 1.7e-6 (values up to
2.5), the reference's f32 noise, not the port's. CLIP and T5 are also held
against transformers on tiny checkpoints written under tmp_path; nothing
is downloaded.
"""

import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pygpukit_tpu.diffusion import FluxPipeline as RefFluxPipeline  # noqa: E402
from pygpukit_tpu.diffusion import schedulers as ref_sched  # noqa: E402
from pygpukit_tpu.diffusion.models import dit as ref_dit  # noqa: E402
from pygpukit_tpu.diffusion.models import flux as ref_flux  # noqa: E402
from pygpukit_tpu.diffusion.models import vae as ref_vae  # noqa: E402
from pygpukit_tpu.diffusion.text_encoders import clip as ref_clip  # noqa: E402
from pygpukit_tpu.diffusion.text_encoders import t5 as ref_t5  # noqa: E402
from pygpukit_tpu_torch.diffusion import FluxPipeline  # noqa: E402
from pygpukit_tpu_torch.diffusion import schedulers as sched  # noqa: E402
from pygpukit_tpu_torch.diffusion.models import flux, vae  # noqa: E402
from pygpukit_tpu_torch.diffusion.models.dit import DiT, DiTConfig  # noqa: E402
from pygpukit_tpu_torch.diffusion.models.flux import (FluxConfig, FluxTransformer,  # noqa: E402
                                                      make_img_ids, patchify, unpatchify)
from pygpukit_tpu_torch.diffusion.models.vae import VAE, VAEConfig  # noqa: E402
from pygpukit_tpu_torch.diffusion.pipeline import denoise_fn  # noqa: E402
from pygpukit_tpu_torch.diffusion.text_encoders import clip, t5  # noqa: E402
from pygpukit_tpu_torch.llm.convert import params_from_jax  # noqa: E402
from pygpukit_tpu_torch.llm.safetensors import save_safetensors  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
CPU = "cpu"
TINY_FLUX = dict(in_channels=16, hidden_size=64, num_heads=4, depth=2, depth_single=2,
                 context_dim=32, pooled_dim=24, axes_dim=(4, 6, 6))
TINY_VAE = dict(block_out_channels=(16, 16), layers_per_block=1, norm_groups=4,
                latent_channels=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    """The reference's param tree as the port's tensors (bytes unchanged)."""
    return params_from_jax(_np(tree))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


def _close_scaled(got, want):
    """rtol 1e-4 and atol 5e-5 of max |want| (FLUX forwards and loops)."""
    _close(got, want, atol=5e-5 * float(np.abs(np.asarray(want, np.float32)).max()))


def _rng_f32(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _jax_normal(seed, shape):
    """The reference's draw: jax.random.normal of PRNGKey(seed)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def _one_level(got, want):
    """uint8 images equal within one level."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


@pytest.fixture(scope="module")
def tiny_flux():
    """(the reference's tiny FluxTransformer, the port's on its params)."""
    ref = ref_flux.FluxTransformer.init_random(ref_flux.FluxConfig(**TINY_FLUX))
    return ref, FluxTransformer(FluxConfig(**TINY_FLUX), _port(ref.params))


@pytest.fixture(scope="module")
def tiny_vae():
    ref = ref_vae.VAE.init_random(ref_vae.VAEConfig(**TINY_VAE))
    return ref, VAE(VAEConfig(**TINY_VAE), _port(ref.params))


@pytest.fixture(scope="module")
def pipes(tiny_flux, tiny_vae):
    """(the reference's pipeline, the port's) on the same weights."""
    (rf, pf), (rv, pv) = tiny_flux, tiny_vae
    return RefFluxPipeline(rf, rv), FluxPipeline(pf, pv)


# ---------------------------------------------------------------- schedulers --

class TestSchedulers:
    def test_flow_matching_sigmas(self):
        s = sched.FlowMatchingScheduler()
        s.set_timesteps(8)
        assert len(s.sigmas) == 9
        assert s.sigmas[0] == pytest.approx(1.0)
        assert s.sigmas[-1] == 0.0
        assert (np.diff(s.sigmas) < 0).all()

    def test_flow_matching_shift(self):
        a, b = sched.FlowMatchingScheduler(shift=1.0), sched.FlowMatchingScheduler(shift=3.0)
        a.set_timesteps(8)
        b.set_timesteps(8)
        assert not np.allclose(a.sigmas[1:-1], b.sigmas[1:-1])

    def test_flow_step_reaches_x0(self):
        """With a perfect velocity v = noise - x0, integrating to sigma 0
        recovers x0, on arrays and on tensors."""
        s = sched.FlowMatchingScheduler()
        s.set_timesteps(4)
        x0, noise = _rng_f32(0, 4, 4), _rng_f32(1, 4, 4)
        for wrap in (np.asarray, torch.from_numpy):
            x, v = wrap(noise.copy()), wrap(noise - x0)
            for i in range(4):
                x = s.step(v, i, x).prev_sample
            _close(x, x0)

    def test_euler_and_ddim_run(self):
        for s in (sched.EulerDiscreteScheduler(), sched.DDIMScheduler()):
            s.set_timesteps(5)
            x = np.ones((2, 2), np.float32)
            out = s.step(np.zeros_like(x), 0, x).prev_sample
            assert np.isfinite(np.asarray(out)).all()

    @pytest.mark.parametrize("name,kw,steps,mu", [
        ("flow_matching", {}, 4, None), ("flow_matching", {"shift": 3.0}, 28, None),
        ("flow_matching", {"use_dynamic_shifting": True}, 8, 1.15),
        ("euler", {}, 30, None), ("ddim", {}, 20, None), ("ddim", {}, 7, None)])
    def test_schedules_bitwise_and_steps_match_the_reference(self, name, kw, steps, mu):
        """sigmas and timesteps bit for bit; a step on arrays and on
        tensors (Python-float coefficients) within rtol 1e-4 of the
        reference's."""
        ref, ours = ref_sched.SCHEDULERS[name](**kw), sched.SCHEDULERS[name](**kw)
        args = (steps,) if mu is None else (steps, mu)
        ref.set_timesteps(*args)
        ours.set_timesteps(*args)
        for attr in ("sigmas", "timesteps"):
            if hasattr(ref, attr):
                a, b = getattr(ref, attr), getattr(ours, attr)
                assert a.dtype == b.dtype and np.array_equal(a, b), attr
        sample, out = _rng_f32(2, 3, 8), _rng_f32(3, 3, 8)
        for i in (0, steps // 2, steps - 1):
            want = np.asarray(ref.step(out, i, sample).prev_sample, np.float32)
            _close(ours.step(out, i, sample).prev_sample, want)
            _close(ours.step(torch.from_numpy(out), i, torch.from_numpy(sample)).prev_sample,
                   want)
        if name == "euler":
            _close(ours.scale_model_input(torch.from_numpy(sample), 3),
                   ref.scale_model_input(sample, 3))


# ----------------------------------------------------------------------- VAE --

class TestVAE:
    def test_decode_shapes(self):
        cfg = VAEConfig(block_out_channels=(32, 32), layers_per_block=1, norm_groups=8,
                        latent_channels=4)
        v = VAE.init_random(cfg, device=CPU)
        z = torch.ones((1, 4, 8, 8))
        assert v.decode(z).shape == (1, 3, 16, 16)           # one upsample (2 blocks)
        out = v.decode_to_images(z)
        assert out.shape == (1, 16, 16, 3) and out.dtype == np.uint8

    def test_init_random_has_the_references_leaves(self):
        cfg = dict(TINY_VAE, block_out_channels=(16, 32, 32))
        ref = _np(ref_vae.VAE.init_random(ref_vae.VAEConfig(**cfg)).params)
        got = VAE.init_random(VAEConfig(**cfg), seed=1, device=CPU).params
        assert set(got) == set(ref)
        assert all(tuple(got[k].shape) == ref[k].shape for k in ref)

    @pytest.mark.parametrize("shift", [0.0, 0.1159])
    def test_decode_and_images_match_the_reference(self, shift):
        """Decode at rtol 1e-4 and uint8 images within one level, with the
        FLUX VAE's shift factor applied too."""
        cfg = dict(TINY_VAE, block_out_channels=(16, 32), shift_factor=shift,
                   scaling_factor=0.3611)
        ref = ref_vae.VAE.init_random(ref_vae.VAEConfig(**cfg), seed=2)
        ours = VAE(VAEConfig(**cfg), _port(ref.params))
        z = _rng_f32(4, 2, 4, 6, 8)
        _close(ours.decode(z), ref.decode(jnp.asarray(z)))
        _one_level(ours.decode_to_images(z), ref.decode_to_images(jnp.asarray(z)))

    def test_encode_mean_and_sample_match_the_reference(self):
        """The posterior's mean, and its sample with the reference's
        jax.random draw fed as ``noise`` (the asymmetric pad before each
        stride-2 conv, the shift factor on the way in)."""
        cfg = dict(TINY_VAE, block_out_channels=(16, 32, 32), shift_factor=0.1159)
        ref = ref_vae.VAE.init_random(ref_vae.VAEConfig(**cfg), seed=3)
        ours = VAE(VAEConfig(**cfg), _port(ref.params))
        x = _rng_f32(5, 1, 3, 24, 16)
        mean = ref.encode(jnp.asarray(x))
        _close(ours.encode(x), mean)
        assert tuple(mean.shape) == (1, 4, 6, 4)
        key = jax.random.PRNGKey(9)
        draw = np.asarray(jax.random.normal(key, mean.shape, jnp.float32))
        _close(ours.encode(x, noise=draw), ref.encode(jnp.asarray(x), key))
        a, b = ours.encode(x, seed=1), ours.encode(x, seed=1)
        assert torch.equal(a, b) and not torch.allclose(a, ours.encode(x))

    def test_diffusers_checkpoint_round_trip_bitwise(self, tmp_path):
        """The diffusers AutoencoderKL names (decoder, encoder, the quant
        convs) written and read back bit for bit, the factors from
        config.json; the loaded VAE decodes as the in-memory one."""
        cfg = VAEConfig(**dict(TINY_VAE, block_out_channels=(16, 32),
                               scaling_factor=0.3611, shift_factor=0.1159))
        v = VAE.init_random(cfg, seed=4, device=CPU)
        g = torch.Generator().manual_seed(5)
        for k in v.params:
            v.params[k] = v.params[k] + 0.01 * torch.randn(v.params[k].shape, generator=g)
        for ours, c in (("post_quant_conv", 4), ("enc.quant_conv", 8)):
            v.params[f"{ours}.w"] = torch.randn((c, c, 1, 1), generator=g) * 0.3
            v.params[f"{ours}.b"] = torch.randn((c,), generator=g) * 0.1
        save_safetensors(tmp_path / "diffusion_pytorch_model.safetensors",
                         vae.diffusers_tensors(v.params, cfg))
        (tmp_path / "config.json").write_text(json.dumps(
            {"scaling_factor": 0.3611, "shift_factor": 0.1159, "block_out_channels": [16, 32],
             "latent_channels": 4, "layers_per_block": 1, "norm_num_groups": 4}))
        got = VAE.from_safetensors(tmp_path, VAEConfig(**dict(
            TINY_VAE, block_out_channels=(16, 32), scaling_factor=0.3611,
            shift_factor=0.1159)), device=CPU)
        assert set(got.params) == set(v.params)
        assert all(torch.equal(got.params[k], v.params[k]) for k in v.params)
        inferred = VAE.from_safetensors(tmp_path, device=CPU).config
        assert (inferred.scaling_factor, inferred.shift_factor, inferred.latent_channels,
                inferred.block_out_channels) == (0.3611, 0.1159, 4, (16, 32))
        z = _rng_f32(6, 1, 4, 4, 4)
        assert torch.equal(got.decode(z), v.decode(z))

    def test_quant_convs_apply_only_when_present(self, tiny_vae):
        """post_quant_conv as the identity leaves decode as it is; a scaled
        one moves it (the reference's trees never have one)."""
        _, ours = tiny_vae
        z = _rng_f32(7, 1, 4, 4, 4)
        base = ours.decode(z)
        eye = dict(ours.params, **{"post_quant_conv.w": torch.eye(4)[:, :, None, None],
                                   "post_quant_conv.b": torch.zeros(4)})
        assert torch.allclose(VAE(ours.config, eye).decode(z), base, atol=1e-6)
        eye["post_quant_conv.w"] = eye["post_quant_conv.w"] * 2
        assert not torch.allclose(VAE(ours.config, eye).decode(z), base, atol=1e-3)


# ---------------------------------------------------------------------- CLIP --

def _clip_ckpt(d, seed: int, act: str = "quick_gelu", projection: bool = False):
    cfg = transformers.CLIPTextConfig(
        vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=16, eos_token_id=99, hidden_act=act,
        projection_dim=24)
    torch.manual_seed(seed)
    cls = (transformers.CLIPTextModelWithProjection if projection
           else transformers.CLIPTextModel)
    m = cls(cfg).eval()
    m.save_pretrained(d, safe_serialization=True)
    return m


class TestCLIPParity:
    def test_matches_transformers(self, tmp_path):
        m = _clip_ckpt(tmp_path, 0)
        enc = clip.CLIPTextEncoder.from_safetensors(tmp_path, device=CPU)
        ids = [5, 10, 20, 99]
        hidden, pooled = enc(ids)
        with torch.no_grad():
            out = m(torch.tensor([ids]))
        _close(hidden, out.last_hidden_state[0].numpy(), rtol=1e-4, atol=1e-5)
        _close(pooled, out.pooler_output[0].numpy(), rtol=1e-4, atol=1e-5)

    def test_pooled_first_eos_with_eos_padding(self, tmp_path):
        """SD3's CLIP tokenizers pad with the EOS token: pooled is read at
        the first EOS, not a later pad slot."""
        m = _clip_ckpt(tmp_path, 1)
        enc = clip.CLIPTextEncoder.from_safetensors(tmp_path, device=CPU)
        ids = [5, 10, 20, 99] + [99] * 12
        _, pooled = enc(ids)
        with torch.no_grad():
            out = m(torch.tensor([ids]))
        _close(pooled, out.pooler_output[0].numpy(), rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("penultimate", [False, True])
    @pytest.mark.parametrize("projection", [False, True])
    def test_matches_the_reference(self, tmp_path, penultimate, projection):
        """The same checkpoint through both packages: hidden (final or
        penultimate) and pooled (through text_projection where present)."""
        m = _clip_ckpt(tmp_path, 2, projection=projection)
        ref = ref_clip.CLIPTextEncoder.from_safetensors(tmp_path)
        ours = clip.CLIPTextEncoder.from_safetensors(tmp_path, device=CPU)
        assert ("text_projection.w" in ours.params) == projection
        ids = [49, 3, 7, 99, 99, 99]
        (rh, rp), (oh, op) = ref(ids, penultimate=penultimate), ours(ids, penultimate)
        _close(oh, rh)
        _close(op, rp)
        if projection and not penultimate:
            with torch.no_grad():
                _close(op, m(torch.tensor([ids])).text_embeds[0].numpy())

    def test_gelu_follows_hidden_act(self, tmp_path):
        """ROADMAP C.16: hidden_act "gelu" (OpenCLIP bigG, SD3's second
        encoder) is the exact erf form in transformers and in the port; the
        reference takes the tanh form for it (its activation differs by
        more than 1e-4 where the port's is torch's erf GELU bit for bit),
        and the port's encoder matches transformers on a "gelu" checkpoint."""
        x = torch.linspace(-6, 6, 2001)
        assert torch.equal(clip._act("gelu", x), torch.nn.functional.gelu(x))
        ref = np.asarray(ref_clip._act("gelu", jnp.asarray(x.numpy())))
        assert np.abs(ref - torch.nn.functional.gelu(x).numpy()).max() > 1e-4
        for tanh_name in ("gelu_new", "gelu_pytorch_tanh"):
            _close(clip._act(tanh_name, x), ref)
        m = _clip_ckpt(tmp_path, 3, act="gelu")
        ids = [5, 10, 20, 99]
        with torch.no_grad():
            want = m(torch.tensor([ids])).last_hidden_state[0].numpy()
        got, _ = clip.CLIPTextEncoder.from_safetensors(tmp_path, device=CPU)(ids)
        _close(got, want)

    def test_hf_tensors_round_trip(self, tmp_path):
        enc = clip.CLIPTextEncoder.init_random(clip.CLIPTextConfig(
            vocab_size=100, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_position_embeddings=16, eos_token_id=99), seed=1, device=CPU, projection=24)
        save_safetensors(tmp_path / "model.safetensors", clip.hf_tensors(enc.params))
        (tmp_path / "config.json").write_text(json.dumps(
            {"vocab_size": 100, "hidden_size": 32, "num_hidden_layers": 2,
             "num_attention_heads": 4, "intermediate_size": 64,
             "max_position_embeddings": 16, "eos_token_id": 99}))
        got = clip.CLIPTextEncoder.from_safetensors(tmp_path, device=CPU)
        for k in ("tok_embed", "pos_embed", "final_ln.w", "text_projection.w"):
            assert torch.equal(got.params[k], enc.params[k])
        assert all(torch.equal(got.params["layers"][k], enc.params["layers"][k])
                   for k in enc.params["layers"])


# ------------------------------------------------------------------------ T5 --

def _t5_ckpt(d, seed: int, ff: str = "gated-gelu"):
    cfg = transformers.T5Config(
        vocab_size=120, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=20,
        feed_forward_proj=ff, decoder_start_token_id=0)
    torch.manual_seed(seed)
    m = transformers.T5EncoderModel(cfg).eval()
    m.save_pretrained(d, safe_serialization=True)
    return m


class TestT5Parity:
    def test_matches_transformers(self, tmp_path):
        m = _t5_ckpt(tmp_path, 0)
        enc = t5.T5Encoder.from_safetensors(tmp_path, device=CPU)
        ids = [3, 17, 42, 9, 1]
        with torch.no_grad():
            want = m(torch.tensor([ids])).last_hidden_state[0].numpy()
        _close(enc(ids), want, rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("ff", ["gated-gelu", "relu"])
    def test_matches_the_reference(self, tmp_path, ff):
        """Both packages on one checkpoint, 40 tokens (past the exact
        buckets), gated-GELU and ReLU feed-forwards."""
        _t5_ckpt(tmp_path, 1, ff)
        ids = list(np.random.default_rng(1).integers(0, 120, 40))
        want = ref_t5.T5Encoder.from_safetensors(tmp_path)(ids)
        _close(t5.T5Encoder.from_safetensors(tmp_path, device=CPU)(ids), want)

    @pytest.mark.parametrize("buckets,max_dist,s", [(8, 20, 40), (32, 128, 300),
                                                    (32, 128, 256), (16, 64, 129)])
    def test_relative_buckets_bitwise(self, buckets, max_dist, s):
        """The integer buckets of every relative position in an s-token
        sequence equal the reference's (f32 log, truncation; exact powers
        of two sit on bucket boundaries)."""
        pos = np.arange(s)
        rel = pos[None, :] - pos[:, None]
        want = np.asarray(ref_t5._relative_buckets(jnp.asarray(rel), buckets, max_dist))
        got = t5._relative_buckets(torch.from_numpy(rel), buckets, max_dist)
        assert np.array_equal(got.numpy(), want)

    def test_sharded_checkpoint_without_prefix(self, tmp_path):
        """A sharded checkpoint (index.json) whose names carry no
        "encoder." prefix and an ``embed_tokens`` embedding: bitwise the
        written values, the encoder as the single-file one."""
        cfg = t5.T5Config(vocab_size=50, d_model=16, d_kv=4, d_ff=32, num_layers=3,
                          num_heads=4, relative_attention_num_buckets=8,
                          relative_attention_max_distance=20)
        enc = t5.T5Encoder.init_random(cfg, seed=2, device=CPU)
        names = t5.hf_tensors(enc.params, cfg, prefix="")
        names["embed_tokens.weight"] = names.pop("shared.weight")
        keys = sorted(names)
        shards = {"model-00001-of-00002.safetensors": keys[: len(keys) // 2],
                  "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
        for fname, ks in shards.items():
            save_safetensors(tmp_path / fname, {k: names[k] for k in ks})
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: f for f, ks in shards.items() for k in ks}}))
        (tmp_path / "config.json").write_text(json.dumps(
            {"vocab_size": 50, "d_model": 16, "d_kv": 4, "d_ff": 32, "num_layers": 3,
             "num_heads": 4, "relative_attention_num_buckets": 8,
             "relative_attention_max_distance": 20}))
        got = t5.T5Encoder.from_safetensors(tmp_path, device=CPU)
        for k in ("tok_embed", "rel_bias", "final_ln.w"):
            assert torch.equal(got.params[k], enc.params[k])
        assert all(torch.equal(got.params["layers"][k], enc.params["layers"][k])
                   for k in enc.params["layers"])
        ids = [1, 5, 9, 30, 2]
        assert torch.equal(got(ids), enc(ids))
        _close(got(ids), ref_t5.T5Encoder.from_safetensors(tmp_path)(ids))


# ----------------------------------------------------------------------- DiT --

DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=2, num_heads=4)


class TestDiT:
    def test_forward_shapes(self):
        m = DiT.init_random(DiTConfig(**DIT), device=CPU)
        assert m(torch.ones((16, 16)), 0.5).shape == (16, 16)   # 4x4 patches, 2*2*4

    def test_adaln_zero_identity_at_init(self):
        """The gates and the final layer are zero at init: the output is 0."""
        m = DiT.init_random(DiTConfig(**DIT), device=CPU)
        assert torch.allclose(m(torch.ones((16, 16)), 0.1), torch.zeros(16, 16))

    @pytest.mark.parametrize("variant", ["plain", "cross", "classes"])
    def test_matches_the_reference(self, variant):
        """Random adaLN and final projections (so every block counts),
        with cross-attention to a context or a class label."""
        kw = {"cross": dict(cross_attention=True, context_dim=24),
              "classes": dict(num_classes=10)}.get(variant, {})
        cfg = dict(DIT, **kw)
        ref = ref_dit.DiT.init_random(ref_dit.DiTConfig(**cfg), seed=4)
        p = _np(ref.params)
        rng = np.random.default_rng(5)
        for tree in (p, p["blocks"]):
            for k in tree:
                if isinstance(tree[k], np.ndarray):
                    tree[k] = (tree[k] + rng.standard_normal(tree[k].shape) * 0.05
                               ).astype(np.float32)
        ref.params = jax.tree.map(jnp.asarray, p)
        ours = DiT(DiTConfig(**cfg), params_from_jax(p))
        x = _rng_f32(6, 16, 16)
        ctx = {"cross": _rng_f32(7, 5, 24), "classes": np.int32(3)}.get(variant)
        want = ref(jnp.asarray(x), 0.3, None if ctx is None else jnp.asarray(ctx))
        _close(ours(x, 0.3, None if ctx is None else torch.as_tensor(ctx)), want)


# ---------------------------------------------------------------------- FLUX --

def _flux_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((16, cfg["in_channels"])).astype(np.float32)
    txt = rng.standard_normal((8, cfg["context_dim"])).astype(np.float32)
    pooled = rng.standard_normal((cfg["pooled_dim"],)).astype(np.float32)
    return img, txt, pooled


class TestFlux:
    def test_patchify_roundtrip(self):
        x = torch.from_numpy(_rng_f32(0, 4, 8, 8))
        tokens = patchify(x)
        assert tokens.shape == (16, 16)
        assert torch.equal(unpatchify(tokens, 4, 8, 8), x)
        assert np.array_equal(tokens.numpy(), np.asarray(ref_flux.patchify(jnp.asarray(x))))
        assert np.array_equal(make_img_ids(4, 3, device=CPU).numpy(),
                              np.asarray(ref_flux.make_img_ids(4, 3)))

    def test_forward_shapes(self):
        m = FluxTransformer.init_random(FluxConfig(**TINY_FLUX, guidance_embed=True),
                                        device=CPU)
        out = m(torch.ones((16, 16)), make_img_ids(4, 4, device=CPU), torch.ones((8, 32)),
                torch.zeros((8, 3), dtype=torch.int32), 0.5, torch.ones((24,)), 3.5)
        assert out.shape == (16, 16) and torch.isfinite(out).all()

    def test_init_random_has_the_references_tree(self, tiny_flux):
        ref, _ = tiny_flux
        got = FluxTransformer.init_random(FluxConfig(**TINY_FLUX), seed=3, device=CPU).params
        want = _np(ref.params)
        assert set(got) == set(want)
        for k in ("double_blocks", "single_blocks"):
            assert set(got[k]) == set(want[k])
        assert all(tuple(a.shape) == b.shape for a, b in zip(
            jax.tree.leaves(got), jax.tree.leaves(want)))

    @pytest.mark.parametrize("guidance", [True, False])
    def test_forward_matches_the_reference(self, guidance):
        cfg = dict(TINY_FLUX, guidance_embed=guidance)
        ref = ref_flux.FluxTransformer.init_random(ref_flux.FluxConfig(**cfg), seed=1)
        ours = FluxTransformer(FluxConfig(**cfg), _port(ref.params))
        img, txt, pooled = _flux_inputs(cfg, 2)
        ids = ref_flux.make_img_ids(4, 4)
        txt_ids = np.zeros((8, 3), np.int32)
        want = ref(jnp.asarray(img), ids, jnp.asarray(txt), jnp.asarray(txt_ids), 0.7,
                   jnp.asarray(pooled), 3.5)
        _close_scaled(ours(img, np.asarray(ids), txt, txt_ids, 0.7, pooled, 3.5), want)

    def test_bf16_leaves_promote_as_jax(self):
        """A bf16-leaf FLUX with f32 activations: the reference's jnp.dot
        promotes to f32 products, and so does the port (never casting an
        activation down): the output is f32 and within f32 tolerance."""
        ref = ref_flux.FluxTransformer.init_random(ref_flux.FluxConfig(**TINY_FLUX), seed=2)
        ref.params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), ref.params)
        ours = FluxTransformer(FluxConfig(**TINY_FLUX), _port(ref.params))
        assert ours.params["double_blocks"]["img_qkv.w"].dtype == torch.bfloat16
        img, txt, pooled = _flux_inputs(TINY_FLUX, 3)
        ids = ref_flux.make_img_ids(4, 4)
        txt_ids = np.zeros((8, 3), np.int32)
        want = ref(jnp.asarray(img), ids, jnp.asarray(txt), jnp.asarray(txt_ids), 0.25,
                   jnp.asarray(pooled), 2.0)
        got = ours(img, np.asarray(ids), txt, txt_ids, 0.25, pooled, 2.0)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        _close_scaled(got, want)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_bfl_checkpoint_round_trip_bitwise(self, tmp_path, dtype):
        """The BFL names written and read back bit for bit (the block
        counts and the guidance embedder read from the names); the
        reference reads the same file to the same forward."""
        cfg = FluxConfig(**dict(TINY_FLUX, depth=2, depth_single=3))
        m = FluxTransformer.init_random(cfg, seed=5, dtype=dtype, device=CPU)
        save_safetensors(tmp_path / "flux.safetensors", flux.bfl_tensors(m.params))
        got = FluxTransformer.from_safetensors(tmp_path, cfg, dtype=dtype, device=CPU)
        inferred = FluxTransformer.from_safetensors(tmp_path, dtype=dtype, device=CPU).config
        assert inferred == FluxConfig(**dict(TINY_FLUX, depth=2, depth_single=3,
                                             axes_dim=FluxConfig().axes_dim))
        for a, b in zip(jax.tree.leaves(got.params), jax.tree.leaves(m.params)):
            assert a.dtype == dtype and torch.equal(a, b)
        assert set(got.params) == set(m.params)
        if dtype == torch.float32:
            ref = ref_flux.FluxTransformer.from_safetensors(
                tmp_path, ref_flux.FluxConfig(**dict(TINY_FLUX, depth=2, depth_single=3)),
                dtype=jnp.float32)
            img, txt, pooled = _flux_inputs(TINY_FLUX, 4)
            ids, txt_ids = ref_flux.make_img_ids(4, 4), np.zeros((8, 3), np.int32)
            want = ref(jnp.asarray(img), ids, jnp.asarray(txt), jnp.asarray(txt_ids), 0.5,
                       jnp.asarray(pooled), 1.0)
            _close_scaled(got(img, np.asarray(ids), txt, txt_ids, 0.5, pooled, 1.0), want)


# ------------------------------------------------------------------ pipeline --

class TestPipeline:
    def test_end_to_end_tiny(self, pipes):
        _, pipe = pipes
        out = pipe(height=32, width=32, num_inference_steps=2)
        # 32/8 = 4 latent; one upsample in the tiny VAE -> an 8x8 image
        assert out.images.shape == (1, 8, 8, 3) and out.images.dtype == np.uint8
        out2 = pipe(height=32, width=32, num_inference_steps=2)
        np.testing.assert_array_equal(out.images, out2.images)

    @pytest.mark.parametrize("steps", [2, 4])
    def test_matches_the_reference_with_its_draw(self, pipes, steps):
        """The reference's jax.random latents fed to the port: latents at
        rtol 1e-4, images within one level; zero text conditioning and a
        prompt's embeddings given."""
        ref, ours = pipes
        want = ref(height=32, width=32, num_inference_steps=steps, seed=3)
        got = ours(height=32, width=32, num_inference_steps=steps,
                   latents=_jax_normal(3, (4, 4, 4)))
        _close_scaled(got.latents, want.latents)
        _one_level(got.images, want.images)
        txt, pooled = _rng_f32(8, 5, 32), _rng_f32(9, 24)
        want = ref(num_inference_steps=steps, seed=4, height=32, width=48,
                   txt_embeds=jnp.asarray(txt), pooled=jnp.asarray(pooled))
        got = ours(num_inference_steps=steps, height=32, width=48, txt_embeds=txt,
                   pooled=pooled, latents=_jax_normal(4, (4, 4, 6)))
        _close_scaled(got.latents, want.latents)
        _one_level(got.images, want.images)

    def test_captured_loop_is_the_eager_loop(self, pipes):
        """On the CPU the captured program is ``denoise_fn`` run eagerly:
        the pipeline's latents equal one eager call bit for bit, one
        program per key, replayed by the second call."""
        _, pipe = pipes
        lat = torch.from_numpy(_jax_normal(5, (4, 4, 4)))
        out = pipe(height=32, width=32, num_inference_steps=3, latents=lat)
        pipe.scheduler.set_timesteps(3)
        img = flux.patchify(lat)
        eager = denoise_fn(pipe.transformer.config, pipe.transformer.params, img,
                        make_img_ids(2, 2, device=CPU), torch.zeros(256, 32),
                        torch.zeros(256, 3, dtype=torch.int32), torch.zeros(24),
                         torch.tensor(3.5), torch.from_numpy(pipe.scheduler.sigmas))
        assert np.array_equal(out.latents, unpatchify(eager, 4, 4, 4).numpy())
        again = pipe(height=32, width=32, num_inference_steps=3, latents=lat)
        assert np.array_equal(out.latents, again.latents)
        exe = pipe.graphs.get(((4, 16), (256, 32), 3))
        assert exe is not None and exe.stats.replays >= 2 and exe.node_count > 0

    def test_from_pretrained_round_trip(self, tmp_path):
        """A checkpoint tree in the reference's layout (a BFL transformer in
        bf16 at head_dim 128, the default rope axes; the VAE; CLIP with a
        projection; a sharded T5) loaded by from_pretrained bit for bit, the
        configs read from the names, shapes and config.json files; with
        character-level tokenizers the loaded pipeline gives the in-memory
        one's image, and the reference's loaders (its from_pretrained infers
        no widths, so each part gets its config) give its latents."""
        fcfg = FluxConfig(in_channels=16, hidden_size=256, num_heads=2, depth=1,
                          depth_single=1, context_dim=32, pooled_dim=24,
                          guidance_embed=False)
        tr = FluxTransformer.init_random(fcfg, seed=6, dtype=torch.bfloat16, device=CPU)
        vcfg = VAEConfig(**TINY_VAE)
        v = VAE.init_random(vcfg, seed=7, device=CPU)
        clip_hf = {"vocab_size": 100, "hidden_size": 32, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "intermediate_size": 48,
                   "max_position_embeddings": 16, "eos_token_id": 99}
        c = clip.CLIPTextEncoder.init_random(clip.CLIPTextConfig.from_hf(clip_hf), seed=8,
                                             device=CPU, projection=24)
        t5_hf = {"vocab_size": 64, "d_model": 32, "d_kv": 8, "d_ff": 48, "num_layers": 2,
                 "num_heads": 4, "relative_attention_num_buckets": 8,
                 "relative_attention_max_distance": 20}
        tcfg = t5.T5Config.from_hf(t5_hf)
        e = t5.T5Encoder.init_random(tcfg, seed=9, device=CPU)
        for sub in ("transformer", "vae", "text_encoder", "text_encoder_2"):
            (tmp_path / sub).mkdir()
        save_safetensors(tmp_path / "transformer" / "flux1-schnell.safetensors",
                         flux.bfl_tensors(tr.params))
        save_safetensors(tmp_path / "vae" / "diffusion_pytorch_model.safetensors",
                         vae.diffusers_tensors(v.params, vcfg))
        (tmp_path / "vae" / "config.json").write_text(json.dumps(
            {"latent_channels": 4, "block_out_channels": [16, 16], "layers_per_block": 1,
             "norm_num_groups": 4, "scaling_factor": 0.18215}))
        save_safetensors(tmp_path / "text_encoder" / "model.safetensors",
                         clip.hf_tensors(c.params))
        (tmp_path / "text_encoder" / "config.json").write_text(json.dumps(clip_hf))
        names = t5.hf_tensors(e.params, tcfg)
        keys = sorted(names)
        shards = {"model-00001-of-00002.safetensors": keys[:9],
                  "model-00002-of-00002.safetensors": keys[9:]}
        for fname, ks in shards.items():
            save_safetensors(tmp_path / "text_encoder_2" / fname, {k: names[k] for k in ks})
        (tmp_path / "text_encoder_2" / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: f for f, ks in shards.items() for k in ks}}))
        (tmp_path / "text_encoder_2" / "config.json").write_text(json.dumps(t5_hf))
        pipe = FluxPipeline.from_pretrained(tmp_path, device=CPU)
        assert pipe.transformer.config == fcfg and pipe.vae.config == vcfg
        for got, want in ((pipe.transformer.params, tr.params), (pipe.vae.params, v.params),
                          (pipe.clip.params, c.params), (pipe.t5.params, e.params)):
            gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
            assert len(gl) == len(wl) and all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(gl, wl))

        def clip_tok(s):
            return ([1] + [ord(ch) % 90 + 2 for ch in s] + [99] * 16)[:16]

        def t5_tok(s):
            return [ord(ch) % 60 + 2 for ch in s] + [1]
        pipe.clip_tokenizer, pipe.t5_tokenizer = clip_tok, t5_tok
        mem = FluxPipeline(tr, v, c, e, clip_tok, t5_tok)
        lat = _jax_normal(6, (4, 4, 4))
        got = pipe("a red fox", 32, 32, 2, latents=lat)
        assert np.array_equal(got.images, mem("a red fox", 32, 32, 2, latents=lat).images)
        ref = RefFluxPipeline(
            ref_flux.FluxTransformer.from_safetensors(
                tmp_path / "transformer", ref_flux.FluxConfig(**{
                    k: getattr(fcfg, k) for k in fcfg.__dataclass_fields__})),
            ref_vae.VAE.from_safetensors(tmp_path / "vae", ref_vae.VAEConfig(**TINY_VAE)),
            ref_clip.CLIPTextEncoder.from_safetensors(tmp_path / "text_encoder"),
            ref_t5.T5Encoder.from_safetensors(tmp_path / "text_encoder_2"),
            clip_tok, t5_tok)
        want = ref("a red fox", 32, 32, 2, seed=6)
        _close_scaled(got.latents, want.latents)
        _one_level(got.images, want.images)


class TestImg2Img:
    def test_img2img_runs_and_deterministic(self, pipes):
        _, pipe = pipes
        img = np.random.default_rng(0).integers(0, 255, (8, 8, 3), dtype=np.uint8)
        out = pipe.img2img(img, strength=0.5, num_inference_steps=4)
        assert out.images.shape == (1, 8, 8, 3)
        out2 = pipe.img2img(img, strength=0.5, num_inference_steps=4)
        np.testing.assert_array_equal(out.images, out2.images)
        far = pipe.img2img(img, strength=1.0, num_inference_steps=4)
        assert not np.array_equal(out.images, far.images)

    def test_strength_validated(self, pipes):
        _, pipe = pipes
        img = np.zeros((8, 8, 3), np.uint8)
        for bad in (0.0, 1.5):
            with pytest.raises(ValueError):
                pipe.img2img(img, strength=bad)

    def test_inpaint_preserves_unmasked_latents(self, pipes):
        _, pipe = pipes
        img = np.random.default_rng(1).integers(0, 255, (8, 8, 3), dtype=np.uint8)
        x0 = pipe._prep_image_latents(img).numpy()               # [4, 4, 4]
        mask = np.zeros((4, 4), np.float32)
        mask[:, 2:] = 1.0                                         # repaint the right half
        out = pipe.inpaint(img, mask, num_inference_steps=3)
        np.testing.assert_allclose(out.latents[:, :, :2], x0[:, :, :2], rtol=0, atol=1e-5)
        assert np.abs(out.latents[:, :, 2:] - x0[:, :, 2:]).max() > 1e-3

    def test_pixel_space_mask_pooled(self, pipes):
        _, pipe = pipes
        mask = np.zeros((8, 8), np.float32)
        mask[0, 4] = 1.0                       # one pixel -> its whole latent cell repainted
        out = pipe.inpaint(np.zeros((8, 8, 3), np.uint8), mask, num_inference_steps=2)
        assert out.images.shape == (1, 8, 8, 3)

    @pytest.mark.parametrize("strength,mask", [(0.5, None), (0.75, "latent"),
                                               (1.0, "pixel")])
    def test_matches_the_reference_with_its_draw(self, pipes, strength, mask):
        """img2img and inpaint with the reference's jax.random noise fed:
        latents at rtol 1e-4, images within one level."""
        ref, ours = pipes
        img = np.random.default_rng(2).integers(0, 255, (8, 8, 3), dtype=np.uint8)
        m = None
        if mask == "latent":
            m = np.zeros((4, 4), np.float32)
            m[1:3, :] = 1.0
        elif mask == "pixel":
            m = np.zeros((8, 8), np.float32)
            m[5, 1] = m[0, 7] = 1.0
        want = ref.img2img(img, strength=strength, num_inference_steps=4, seed=7, mask=m)
        got = ours.img2img(img, strength=strength, num_inference_steps=4, mask=m,
                           noise=_jax_normal(7, (4, 4, 4)))
        _close_scaled(got.latents, want.latents)
        _one_level(got.images, want.images)
