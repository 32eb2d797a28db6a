"""Kokoro-82M from its checkpoint: the synthesis entry point (counterpart
of ``pygpukit_tpu/tts/kokoro/pretrained.py``).

``synthesize`` runs ``arch.kmodel_forward`` as one captured program per
(phonemes, frame budget), as the reference keeps one jit per key: on the
card the first call captures a CUDA graph (``core.capture``) with the
weights bound in place, and every call replays it with the phoneme ids,
the voice row, the speed and the sine source's two draws copied into its
static inputs. The draws come from a ``torch.Generator`` on the model's
device seeded with ``seed`` (the reference's ``jax.random`` bits cannot
be repeated). The host reads ``true_total`` once, to trim the audio.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from ...core.backend import resolve_device
from ...core.executable import ExecutableCache
from ...ops.precision import f32_matmul_context
from .arch import kmodel_forward, samples_per_frame, sine_draws
from .checkpoint import (
    KokoroDims, init_random_flat, load_checkpoint_file, load_config_file,
    load_params, load_voice_file, select_ref_s, to_device,
)
from .g2p import Phonemizer
from .model import SynthesisResult

SAMPLE_RATE = 24000


def _forward(dims: KokoroDims, total: int, max_frames: int, params, ids, ref, speed,
             rand_ini, noise):
    """``kmodel_forward`` with the budget and the model's depth fixed, the
    params first (bound by a capture)."""
    return kmodel_forward(ids, ref, params, speed=speed, total_frames=total,
                          n_albert_layers=dims.albert_layers, albert_heads=dims.albert_heads,
                          max_frames_per_token=max_frames, draws=(rand_ini, noise))


class Kokoro82M:
    """Kokoro-82M synthesis over ``arch.py`` on one device.

    Use ``from_pretrained(dir)`` for a checkpoint (kokoro-v1_0.pth or
    .safetensors + config.json + voices/*.pt) or ``random_init()`` for a
    weight-free demo/test instance. ``params`` (the ``load_params`` tree)
    go to ``device``, the card unless named.
    """

    #: frame budget per token (max_dur in the checkpoint is 50, typical
    #: speech sits well under 20; raise for texts with long pauses)
    max_frames_per_token = 20

    def __init__(self, params: dict, dims: KokoroDims | None = None,
                 vocab: dict[str, int] | None = None,
                 voices: dict[str, np.ndarray] | None = None, device=None):
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.dims = dims or KokoroDims()
        self.phonemizer = Phonemizer(vocab or None)
        self.voices = dict(voices or {})
        self._current_voice: str | None = next(iter(self.voices), None)
        self.graphs = ExecutableCache(shared_pool=True)

    # ------------------------------------------------------------- loading

    @classmethod
    def from_pretrained(cls, model_path, voice: str = "af_heart",
                        load_all_voices: bool = False, device=None) -> "Kokoro82M":
        """Load from a Kokoro-82M snapshot directory (or a single weight
        file) onto ``device`` (the card unless named). Reads config.json
        for dims+vocab when present; loads the requested voice (or all)."""
        dev = resolve_device(device)
        path = Path(model_path)
        if path.is_file():
            weight_file, root = path, path.parent
        else:
            root = path
            for name in ("kokoro-v1_0.pth", "kokoro-v1_0.safetensors"):
                if (root / name).exists():
                    weight_file = root / name
                    break
            else:
                cands = (sorted(root.glob("*.pth"))
                         + sorted(root.glob("*.safetensors")))
                if not cands:
                    raise FileNotFoundError(f"no checkpoint under {root}")
                weight_file = cands[0]

        dims, vocab = KokoroDims(), None
        if (root / "config.json").exists():
            dims, vocab = load_config_file(root / "config.json")
            vocab = vocab or None

        params = load_params(load_checkpoint_file(weight_file), dims, dev)

        voices: dict[str, np.ndarray] = {}
        vdir = root / "voices"
        if vdir.exists():
            names = ([p.stem for p in sorted(vdir.glob("*.pt"))]
                     if load_all_voices else
                     [voice] if (vdir / f"{voice}.pt").exists() else
                     [p.stem for p in sorted(vdir.glob("*.pt"))[:1]])
            for name in names:
                f = vdir / f"{name}.pt"
                if f.exists():
                    voices[name] = load_voice_file(f)
        model = cls(params, dims, vocab, voices, dev)
        if voice in model.voices:
            model.set_voice(voice)
        return model

    @classmethod
    def random_init(cls, seed: int = 0, scale: float = 0.05, device=None) -> "Kokoro82M":
        """Architecture-exact random instance (tests, offline demos): the
        reference's checkpoint and demo voice for ``seed``."""
        dev = resolve_device(device)
        params = load_params(init_random_flat(seed=seed, scale=scale), device=dev)
        rng = np.random.default_rng(seed)
        voices = {"demo": rng.standard_normal((510, 1, 256)).astype(
            np.float32) * 0.1}
        return cls(params, voices=voices, device=dev)

    # -------------------------------------------------------------- voices

    def set_voice(self, name: str) -> None:
        if name not in self.voices:
            raise KeyError(f"unknown voice {name!r}; have "
                           f"{list(self.voices)}")
        self._current_voice = name

    def load_voice(self, voice_path) -> str:
        path = Path(voice_path)
        self.voices[path.stem] = load_voice_file(path)
        if self._current_voice is None:
            self._current_voice = path.stem
        return path.stem

    @property
    def available_voices(self) -> list[str]:
        return list(self.voices)

    @property
    def current_voice(self) -> str | None:
        return self._current_voice

    # ----------------------------------------------------------- synthesis

    def ref_s(self, n_tokens: int) -> torch.Tensor:
        """The current voice's row for ``n_tokens`` phonemes (zeros without
        a voice), [256] on the model's device."""
        if self._current_voice is not None:
            ref = select_ref_s(self.voices[self._current_voice], n_tokens)
        else:
            ref = np.zeros(256, np.float32)
        return torch.as_tensor(np.ascontiguousarray(ref), device=self.device)

    def forward(self, ids: torch.Tensor, ref_s: torch.Tensor, speed: float, draws):
        """(audio [budget samples], pred_dur [S+2], true_total) of int32
        ``ids`` [S] by the captured program of (S, budget): copies, so a
        later call leaves them as they are."""
        total = (ids.shape[0] + 2) * self.max_frames_per_token
        rand_ini, noise = draws
        with f32_matmul_context(self.params):   # Kokoro weights are f32
            exe = self.graphs.get_or_capture(
                (ids.shape[0], total),
                functools.partial(_forward, self.dims, total, self.max_frames_per_token),
                self.params, ids, ref_s, float(speed), rand_ini, noise,
                bound_argnums=(0,), name=f"kokoro82m_{ids.shape[0]}")
            out = exe.replay(self.params, ids, ref_s, float(speed), rand_ini, noise)
        return tuple(t.clone() for t in out)

    def draws(self, n_tokens: int, seed: int):
        """The sine source's draws for ``n_tokens`` phonemes from a
        generator on the model's device seeded with ``seed``."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        total = (n_tokens + 2) * self.max_frames_per_token
        return sine_draws(total * samples_per_frame(), g)

    def synthesize(self, text: str | None = None, voice: str | None = None,
                   speed: float = 1.0, phonemes: str | None = None,
                   seed: int = 0) -> SynthesisResult:
        """Text (or raw IPA ``phonemes``) -> audio. One captured program per
        phoneme-sequence length."""
        if voice is not None:
            self.set_voice(voice)
        ps = phonemes if phonemes is not None else self.phonemizer.phonemize(
            text or "")
        id_list = self.phonemizer.encode(phonemes=ps) or [16]
        ids = torch.tensor(id_list, dtype=torch.int32, device=self.device)
        audio_full, _, true_total = self.forward(
            ids, self.ref_s(len(id_list)), speed, self.draws(len(id_list), seed))
        n = int(true_total) * samples_per_frame()
        audio = audio_full[:n].cpu().numpy()
        return SynthesisResult(audio=audio, sample_rate=SAMPLE_RATE,
                               duration=len(audio) / SAMPLE_RATE,
                               phonemes=ps)

    def synthesize_streaming(self, text: str, voice: str | None = None,
                             chunk_chars: int = 64, speed: float = 1.0):
        """Sentence/segment streaming (reference: generate_stream)."""
        cur = ""
        for ch in text:
            cur += ch
            if ch in ".!?" or len(cur) >= chunk_chars:
                if cur.strip():
                    yield self.synthesize(cur.strip(), voice, speed)
                cur = ""
        if cur.strip():
            yield self.synthesize(cur.strip(), voice, speed)
