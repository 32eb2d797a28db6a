"""Text-to-image pipelines (counterpart of ``pygpukit_tpu/diffusion/pipeline.py``).

``FluxPipeline``: encode_prompt (CLIP pooled + T5 sequence), the
flow-matching Euler loop over the FLUX transformer, the VAE decode; with
img2img and inpainting. The reference compiles the whole denoise loop as
one executable per key shape; here it is one captured program per key
(``core.capture`` through the pipeline's ``graphs``): the sigma pairs live
on the device and no step reads the host, so on the card the loop replays
as one CUDA graph, and on the CPU the program is the eager loop
(``denoise_fn``). ``PixArtPipeline`` (DDIM with classifier-free guidance)
and ``SD3Pipeline`` (CLIP-L/G plus T5 conditioning, flow matching with
guidance) step eagerly, as the reference's Python loops do, their latents
on the device throughout.

Draws: the reference draws its latents and noise from ``jax.random``; here
a ``torch.Generator`` on the pipeline's device seeded with ``seed`` draws
them, and every entry point also takes the draw as a tensor (``latents=``,
``noise=``), so a caller (a parity test) can feed the reference's values.

Precision: every product of these stacks is f32 (a bf16 FLUX promotes its
weights against f32 activations), so the entry points scope
``ops.precision.full_f32_context`` (TF32 off for cuBLAS and cuDNN) where
the reference scopes only f32 models; the VAE and the text encoders scope
their own params besides.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..core.executable import ExecutableCache
from ..ops.precision import full_f32_context
from ._common import tensor_on
from .models.flux import FluxTransformer, flux_forward_fn, make_img_ids, patchify, unpatchify
from .models.vae import VAE
from .schedulers import DDIMScheduler, FlowMatchingScheduler

_F32 = torch.float32


@dataclass
class PipelineOutput:
    images: np.ndarray          # uint8 [N, H, W, 3]
    latents: np.ndarray | None = None


def _f32_scoped(fn):
    """Run the whole entry point with f32 products (TF32 off)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with full_f32_context():
            return fn(self, *args, **kwargs)
    return wrapper


def _draw(shape: tuple, seed: int, device) -> torch.Tensor:
    """Standard normal f32 of ``shape`` on ``device`` from a generator
    seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=device)


def denoise_fn(cfg, params, img, img_ids, txt, txt_ids, pooled, guidance, sigmas,
               x0_tok=None, noise_tok=None, mask_tok=None):
    """The flow-matching Euler loop: for each sigma pair (s, s_next) of
    ``sigmas`` [n + 1] (a device tensor, never read on the host) the
    velocity at s, then img + (s_next - s) v; with ``mask_tok`` the known
    region (mask 0) is set back to its noised original at s_next after each
    step (inpainting)."""
    for i in range(sigmas.shape[0] - 1):
        s_cur, s_next = sigmas[i], sigmas[i + 1]
        v = flux_forward_fn(cfg, params, img, img_ids, txt, txt_ids, s_cur, pooled, guidance)
        img = img + (s_next - s_cur) * v
        if mask_tok is not None:
            known = (1.0 - s_next) * x0_tok + s_next * noise_tok
            img = mask_tok * img + (1.0 - mask_tok) * known
    return img


class FluxPipeline:
    """FLUX text-to-image (reference: ``FluxPipeline``) on the transformer's
    device."""

    def __init__(self, transformer: FluxTransformer, vae: VAE,
                 clip_encoder=None, t5_encoder=None,
                 clip_tokenizer=None, t5_tokenizer=None,
                 scheduler: FlowMatchingScheduler | None = None):
        self.transformer = transformer
        self.vae = vae
        self.clip = clip_encoder
        self.t5 = t5_encoder
        self.clip_tokenizer = clip_tokenizer
        self.t5_tokenizer = t5_tokenizer
        self.scheduler = scheduler or FlowMatchingScheduler(
            shift=1.0, use_dynamic_shifting=False)
        self.device = transformer.device
        self.graphs = ExecutableCache(shared_pool=True)

    @classmethod
    def from_pretrained(cls, model_dir, dtype=torch.bfloat16, device=None) -> "FluxPipeline":
        """The transformer (in ``dtype``), the VAE and the text encoders
        (f32) from a local checkpoint tree: ``transformer/``, ``vae/``,
        ``text_encoder/`` (CLIP) and ``text_encoder_2/`` (T5) where present,
        on ``device`` (the card unless named)."""
        from .text_encoders.clip import CLIPTextEncoder
        from .text_encoders.t5 import T5Encoder
        d = Path(model_dir)
        transformer = FluxTransformer.from_safetensors(d / "transformer", dtype=dtype,
                                                       device=device)
        dev = transformer.device
        vae = VAE.from_safetensors(d / "vae", device=dev)
        clip = (CLIPTextEncoder.from_safetensors(d / "text_encoder", device=dev)
                if (d / "text_encoder").exists() else None)
        t5 = (T5Encoder.from_safetensors(d / "text_encoder_2", device=dev)
              if (d / "text_encoder_2").exists() else None)
        return cls(transformer, vae, clip, t5)

    # -- prompt encoding -----------------------------------------------------

    def encode_prompt(self, prompt: str, max_t5_len: int = 256):
        """(T5 sequence [T, context_dim], CLIP pooled [pooled_dim]); zeros
        for an encoder or tokenizer that is missing."""
        cfg = self.transformer.config
        if self.clip is not None and self.clip_tokenizer is not None:
            _, pooled = self.clip(self.clip_tokenizer(prompt))
        else:
            pooled = torch.zeros((cfg.pooled_dim,), dtype=_F32, device=self.device)
        if self.t5 is not None and self.t5_tokenizer is not None:
            txt = self.t5(self.t5_tokenizer(prompt)[:max_t5_len])
        else:
            txt = torch.zeros((max_t5_len, cfg.context_dim), dtype=_F32, device=self.device)
        return txt, pooled

    # -- generation ----------------------------------------------------------

    def _denoise(self, key, img, img_ids, txt, pooled, guidance: float,
                 sigmas: np.ndarray, x0_tok=None, noise_tok=None, mask_tok=None):
        """``denoise_fn`` on these inputs by the captured program of
        ``key`` (captured at the first call)."""
        dev = self.device
        txt_ids = torch.zeros((txt.shape[0], 3), dtype=torch.int32, device=dev)
        args = (self.transformer.params, img, img_ids, tensor_on(txt, dev), txt_ids,
                tensor_on(pooled, dev), torch.tensor(guidance, dtype=_F32, device=dev),
                torch.from_numpy(sigmas).to(dev), x0_tok, noise_tok, mask_tok)
        exe = self.graphs.get_or_capture(
            key, functools.partial(denoise_fn, self.transformer.config), *args,
            bound_argnums=(0,), name=f"flux_denoise_{len(sigmas) - 1}")
        return exe.replay(*args)

    @_f32_scoped
    def __call__(self, prompt: str = "", height: int = 256, width: int = 256,
                 num_inference_steps: int = 4, guidance_scale: float = 3.5,
                 seed: int = 0, txt_embeds=None, pooled=None, latents=None) -> PipelineOutput:
        """Text to image: the latents [C, H/8, W/8] drawn from ``seed``
        (or given), the denoise loop, the VAE decode."""
        lat_c = self.vae.config.latent_channels
        lat_h, lat_w = height // 8, width // 8
        latents = (_draw((lat_c, lat_h, lat_w), seed, self.device) if latents is None
                   else tensor_on(latents, self.device, _F32))
        if txt_embeds is None or pooled is None:
            txt_embeds, pooled = self.encode_prompt(prompt)
        self.scheduler.set_timesteps(num_inference_steps)
        img = patchify(latents)
        img_ids = make_img_ids(lat_h // 2, lat_w // 2, device=self.device)
        key = (tuple(img.shape), tuple(txt_embeds.shape), num_inference_steps)
        img = self._denoise(key, img, img_ids, txt_embeds, pooled, guidance_scale,
                            np.asarray(self.scheduler.sigmas, np.float32))
        latents = unpatchify(img, lat_c, lat_h, lat_w)
        images = self.vae.decode_to_images(latents[None])
        return PipelineOutput(images=images, latents=latents.cpu().numpy())

    generate = __call__

    # -- image-conditioned variants -------------------------------------------

    def _prep_image_latents(self, image) -> torch.Tensor:
        """uint8 [H, W, 3] (or float in [0, 1]) -> latents [Cz, H/8, W/8]
        (the posterior's mean)."""
        x = np.asarray(image)
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        x = x.astype(np.float32) * 2.0 - 1.0                 # [-1, 1]
        return self.vae.encode(np.ascontiguousarray(x.transpose(2, 0, 1))[None])[0]

    @_f32_scoped
    def img2img(self, image, prompt: str = "", strength: float = 0.6,
                num_inference_steps: int = 4, guidance_scale: float = 3.5, seed: int = 0,
                txt_embeds=None, pooled=None, mask=None, noise=None) -> PipelineOutput:
        """Image to image: the VAE-encoded image noised to the flow-matching
        point ``strength`` picks (x_s = (1 - s) x0 + s noise), then the rest
        of the schedule. With ``mask`` (H/8 x W/8, or H x W max-pooled to
        it; 1 = repaint) this is inpainting: after every step the known
        region is set back to its original at the current noise level."""
        if not 0.0 < strength <= 1.0:
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        x0 = self._prep_image_latents(image)                  # [Cz, h, w]
        lat_c, lat_h, lat_w = x0.shape
        noise = (_draw(tuple(x0.shape), seed, self.device) if noise is None
                 else tensor_on(noise, self.device, _F32))

        self.scheduler.set_timesteps(num_inference_steps)
        sigmas_full = np.asarray(self.scheduler.sigmas, np.float32)
        i0 = min(int(round(num_inference_steps * (1.0 - strength))), num_inference_steps - 1)
        sigmas = sigmas_full[i0:]
        s0 = float(sigmas_full[i0])

        if txt_embeds is None or pooled is None:
            txt_embeds, pooled = self.encode_prompt(prompt)
        x0_tok, noise_tok = patchify(x0), patchify(noise)
        img = (1.0 - s0) * x0_tok + s0 * noise_tok
        mask_tok = None
        if mask is not None:
            m = np.asarray(mask, np.float32)
            if m.shape != (lat_h, lat_w):        # a pixel-space mask: max-pool to the latent
                m = m.reshape(lat_h, m.shape[0] // lat_h,
                              lat_w, m.shape[1] // lat_w).max(axis=(1, 3))
            mask_tok = patchify(torch.from_numpy(np.ascontiguousarray(m)).to(self.device)
                                [None].expand(lat_c, lat_h, lat_w))
        img_ids = make_img_ids(lat_h // 2, lat_w // 2, device=self.device)
        key = ("i2i", tuple(img.shape), tuple(txt_embeds.shape), len(sigmas_full) - i0,
               mask is not None)
        img = self._denoise(key, img, img_ids, txt_embeds, pooled, guidance_scale, sigmas,
                            x0_tok, noise_tok, mask_tok)
        latents = unpatchify(img, lat_c, lat_h, lat_w)
        images = self.vae.decode_to_images(latents[None])
        return PipelineOutput(images=images, latents=latents.cpu().numpy())

    def inpaint(self, image, mask, prompt: str = "", num_inference_steps: int = 4,
                guidance_scale: float = 3.5, seed: int = 0, strength: float = 1.0,
                txt_embeds=None, pooled=None, noise=None) -> PipelineOutput:
        """Masked regeneration (mask: 1 = repaint, 0 = keep; pixel- or
        latent-resolution)."""
        return self.img2img(image, prompt=prompt, strength=strength,
                            num_inference_steps=num_inference_steps,
                            guidance_scale=guidance_scale, seed=seed,
                            txt_embeds=txt_embeds, pooled=pooled, mask=mask, noise=noise)


class Text2ImagePipeline(FluxPipeline):
    """Generic facade (reference: ``Text2ImagePipeline``): the SD3/PixArt
    variants share the flow-matching loop; the family is the transformer
    passed in."""


class PixArtPipeline:
    """PixArt-alpha text-to-image: T5 captions -> the ada_norm_single DiT ->
    DDIM epsilon sampling -> the VAE decode."""

    def __init__(self, transformer, vae: VAE | None = None, t5_encoder=None,
                 t5_tokenizer=None, scheduler=None):
        self.transformer = transformer
        self.vae = vae
        self.t5 = t5_encoder
        self.t5_tokenizer = t5_tokenizer
        self.scheduler = scheduler or DDIMScheduler()
        self.device = transformer.device

    @classmethod
    def from_pretrained(cls, model_dir, config=None, device=None) -> "PixArtPipeline":
        """The diffusers PixArt layout: transformer/, vae/, text_encoder/
        (T5), tokenizer/ (read by transformers where it is installed), on
        ``device`` (the card unless named)."""
        from .models.pixart import PixArtTransformer
        from .text_encoders.t5 import T5Encoder
        d = Path(model_dir)
        transformer = PixArtTransformer.from_safetensors(d / "transformer", config,
                                                         device=device)
        dev = transformer.device
        vae = VAE.from_safetensors(d / "vae", device=dev) if (d / "vae").exists() else None
        t5 = (T5Encoder.from_safetensors(d / "text_encoder", device=dev)
              if (d / "text_encoder").exists() else None)
        tok = None
        try:
            from transformers import AutoTokenizer
            if (d / "tokenizer").exists():
                tok = AutoTokenizer.from_pretrained(str(d / "tokenizer"))
        except (ImportError, OSError, ValueError):   # no tokenizer: the offline stub
            pass
        return cls(transformer, vae, t5, tok)

    def encode_prompt(self, prompt: str, max_len: int = 120) -> torch.Tensor:
        if self.t5 is None:
            raise RuntimeError("no text encoder loaded")
        if self.t5_tokenizer is not None:
            ids = self.t5_tokenizer(prompt, max_length=max_len, truncation=True)["input_ids"]
        else:
            ids = [ord(c) % 1000 for c in prompt][:max_len]     # the offline stub
        return self.t5(ids)

    @_f32_scoped
    def generate(self, prompt: str = "", num_steps: int = 20, guidance_scale: float = 4.5,
                 seed: int = 0, caption_embeds=None, negative_embeds=None, latents=None):
        """-> latents [C, H, W] (uint8 images through ``.vae`` when it is
        set). ``caption_embeds`` bypasses the text encoder; the unconditional
        branch encodes "" through T5 when there is one, else zeros."""
        cfg = self.transformer.config
        c = (tensor_on(caption_embeds, self.device) if caption_embeds is not None
             else self.encode_prompt(prompt))
        if negative_embeds is not None:
            uc = tensor_on(negative_embeds, self.device)
        elif self.t5 is not None:
            uc = self.encode_prompt("")
        else:
            uc = torch.zeros_like(c)
        self.scheduler.set_timesteps(num_steps)
        shape = (cfg.in_channels, cfg.sample_size, cfg.sample_size)
        lat = (_draw(shape, seed, self.device) if latents is None
               else tensor_on(latents, self.device, _F32))
        for i, t in enumerate(self.scheduler.timesteps):
            eps_c = self.transformer(lat, float(t), c)[:cfg.in_channels]
            if guidance_scale != 1.0:
                eps_u = self.transformer(lat, float(t), uc)[:cfg.in_channels]
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            else:
                eps = eps_c
            lat = self.scheduler.step(eps, i, lat).prev_sample
        if self.vae is not None:
            return self.vae.decode_to_images(lat[None])
        return lat


class SD3Pipeline:
    """Stable Diffusion 3 text-to-image: the MMDiT and rectified-flow
    sampling with classifier-free guidance."""

    def __init__(self, transformer, vae: VAE | None = None, t5_encoder=None,
                 clip_encoders=None, scheduler=None):
        self.transformer = transformer
        self.vae = vae
        self.t5 = t5_encoder
        self.clips = clip_encoders or []
        self.clip_tokenizers: list = []
        self.t5_tokenizer = None
        self.scheduler = scheduler or FlowMatchingScheduler(
            shift=3.0, use_dynamic_shifting=False)
        self.device = transformer.device

    @classmethod
    def from_pretrained(cls, model_dir, config=None, device=None) -> "SD3Pipeline":
        """The diffusers SD3 layout: transformer/, vae/, text_encoder{,_2}/
        (CLIP-L/G), text_encoder_3/ (T5), tokenizer{,_2,_3}/ (read by
        transformers where it is installed), on ``device`` (the card unless
        named)."""
        from .models.sd3 import SD3Transformer
        from .text_encoders.clip import CLIPTextEncoder
        from .text_encoders.t5 import T5Encoder
        d = Path(model_dir)
        transformer = SD3Transformer.from_safetensors(d / "transformer", config, device=device)
        dev = transformer.device
        vae = VAE.from_safetensors(d / "vae", device=dev) if (d / "vae").exists() else None
        clips = [CLIPTextEncoder.from_safetensors(d / n, device=dev)
                 for n in ("text_encoder", "text_encoder_2") if (d / n).exists()]
        t5 = (T5Encoder.from_safetensors(d / "text_encoder_3", device=dev)
              if (d / "text_encoder_3").exists() else None)
        pipe = cls(transformer, vae, t5, clips)
        try:
            from transformers import AutoTokenizer
            pipe.clip_tokenizers = [AutoTokenizer.from_pretrained(str(d / n))
                                    for n in ("tokenizer", "tokenizer_2") if (d / n).exists()]
            if (d / "tokenizer_3").exists():
                pipe.t5_tokenizer = AutoTokenizer.from_pretrained(str(d / "tokenizer_3"))
        except (ImportError, OSError, ValueError) as e:
            import warnings
            warnings.warn(f"SD3 tokenizers not loaded ({e!r}); generate(prompt=...) needs "
                          "pre-computed embeds", stacklevel=2)
        return pipe

    def encode_prompt(self, prompt: str, max_t5_len: int = 256):
        """-> (context [77 + T, ctx_dim], pooled [pooled_dim]): the CLIP-L/G
        hiddens concatenated on features and zero-padded to the T5 width,
        stacked with the T5 sequence (the diffusers SD3 recipe)."""
        cfg = self.transformer.config
        if not self.clips or not self.clip_tokenizers:
            raise RuntimeError("text encoders/tokenizers not loaded; pass "
                               "caption_embeds/pooled_embeds instead")
        hiddens, pooleds = [], []
        for clip, tok in zip(self.clips, self.clip_tokenizers):
            ids = tok(prompt, padding="max_length", max_length=77,
                      truncation=True)["input_ids"]
            # SD3: the penultimate hidden states condition the MMDiT; pooled
            # is the projected final-layer EOS hidden
            try:
                h, pooled = clip(ids, penultimate=True)
            except TypeError:      # duck-typed encoders
                h, pooled = clip(ids)
            hiddens.append(tensor_on(h, self.device))
            pooleds.append(tensor_on(pooled, self.device))
        clip_cat = torch.cat(hiddens, dim=-1)
        clip_cat = F.pad(clip_cat, (0, cfg.context_dim - clip_cat.shape[-1]))
        parts = [clip_cat]
        if self.t5 is not None and self.t5_tokenizer is not None:
            # padded to max_t5_len: one shape a pipeline, whatever the prompt
            t5_ids = self.t5_tokenizer(prompt, max_length=max_t5_len, truncation=True,
                                       padding="max_length")["input_ids"]
            parts.append(self.t5(t5_ids))
        return torch.cat(parts), torch.cat([p.reshape(-1) for p in pooleds])

    @_f32_scoped
    def generate(self, caption_embeds=None, pooled_embeds=None, num_steps: int = 28,
                 guidance_scale: float = 7.0, seed: int = 0, negative_embeds=None,
                 negative_pooled=None, prompt: str | None = None,
                 negative_prompt: str = "", latents=None):
        """A prompt (through the loaded encoders) or a pre-computed context
        [Tc, ctx_dim] and pooled [pooled_dim] -> latents [C, H, W] (uint8
        images through ``.vae`` when it is set)."""
        if caption_embeds is None:
            caption_embeds, pooled_embeds = self.encode_prompt(prompt or "")
            if guidance_scale != 1.0 and negative_embeds is None:
                negative_embeds, negative_pooled = self.encode_prompt(negative_prompt)
        cfg = self.transformer.config
        c, pc = tensor_on(caption_embeds, self.device), tensor_on(pooled_embeds, self.device)
        uc = (tensor_on(negative_embeds, self.device) if negative_embeds is not None
              else torch.zeros_like(c))
        upc = (tensor_on(negative_pooled, self.device) if negative_pooled is not None
               else torch.zeros_like(pc))
        self.scheduler.set_timesteps(num_steps)
        shape = (cfg.in_channels, cfg.sample_size, cfg.sample_size)
        lat = (_draw(shape, seed, self.device) if latents is None
               else tensor_on(latents, self.device, _F32))
        for i in range(num_steps):
            t = float(self.scheduler.timesteps[i])        # sigma * 1000
            v_c = self.transformer(lat, t, c, pc)
            if guidance_scale != 1.0:
                v_u = self.transformer(lat, t, uc, upc)
                v = v_u + guidance_scale * (v_c - v_u)
            else:
                v = v_c
            lat = self.scheduler.step(v, i, lat).prev_sample
        if self.vae is not None:
            return self.vae.decode_to_images(lat[None])
        return lat
