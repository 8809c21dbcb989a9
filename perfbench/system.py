"""The system under test, built from a configuration file: the program's
predictor with the benchmark's weights, and the tap that keeps what the
timed path produced for the windows the comparison samples.

A configuration names its ``kind``, which is found by name:
``perfbench/kinds/<kind>.py`` builds the program's predictor and session
and says what the comparison needs of that kind;
``perfbench/reference/<kind>.py`` is the plain reference beside it.  Its
``model`` and ``feature`` groups are the program's dataclass fields.
"""

from __future__ import annotations

import dataclasses
import importlib
from collections import defaultdict

import torch

__all__ = ["System", "Tap", "fields", "kind_module", "DENOISED"]

# where the pre-decision chain, which every kind shares, re-quantizes the
# denoised window to PCM16, (module, name): its output is the detector's
# and the trim's input, which the tap keeps for the sampled streams
DENOISED = (("mmla_audio_torch.streaming.session", "quantize_i16"),)


def kind_module(kind: str):
    """``perfbench/kinds/<kind>.py``."""
    return importlib.import_module(f"perfbench.kinds.{kind}")


def fields(cls, values: dict):
    """``cls`` from the keys of ``values`` that are its fields."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in values.items() if k in names})


class System:
    """``kind`` (its module), ``cfg`` (the program's ``PipelineConfig``),
    ``sd`` (the weights), ``pred`` (the program's predictor), ``ref`` (the
    reference module) and the configuration itself."""

    def __init__(self, config: dict, seed: int, device):
        from perfbench import gen

        self.config = config
        self.kind = config["kind"]
        self.device = torch.device(device)
        self.of_kind = kind_module(self.kind)
        self.ref = importlib.import_module(f"perfbench.reference.{self.kind}")
        self.model = config["model"]
        self.feature = config["feature"]
        self.sd = gen.weights(self.ref.param_spec(self.model), seed,
                              self.device)
        self.cfg, self.pred, self.silent_samples = self.of_kind.build(self)

    def tap(self, rows_of, sampled, K: int) -> "Tap":
        return Tap(self.pred, rows_of, sampled, K, self.of_kind)

    def session(self, capture, dirs):
        """The kind's streaming session over ``capture``."""
        return self.of_kind.session(self, capture, dirs)

    def label_name(self, label: int) -> str:
        return self.of_kind.label_name(label)

    # -- the reference -------------------------------------------------------
    def ref_inputs(self, trimmed, kept) -> torch.Tensor:
        """The model's input rows of trimmed int16 windows, by the
        reference."""
        return self.of_kind.ref_inputs(self, trimmed, kept)

    def ref_inputs_of_program(self, rows) -> torch.Tensor:
        """The model's input rows, by the reference, of what the program's
        featurizer was given (rows the tap kept)."""
        return self.of_kind.ref_inputs_of_program(self, rows)

    def program_trimmed(self, fin) -> tuple:
        """(int16 samples, kept count or None) of the trimmed window the
        program's featurizer was given (a row the tap kept)."""
        return self.of_kind.program_trimmed(fin)

    def inputs_agree(self, xp, xr, limits) -> bool:
        return self.of_kind.inputs_agree(xp, xr, limits)

    def ref_logits(self, x: torch.Tensor, precision: str = "fp32"
                   ) -> torch.Tensor:
        """Reference logits of model inputs ``x`` at ``precision`` (the
        kind's names; ``fp32`` is IEEE fp32), TF32 off in the libraries."""
        with _tf32_off():
            return self.of_kind.ref_logits(self, x, precision).float()

    def block_gaps(self, blocks: dict, precision: str = None) -> list:
        """For each window's kept calls of the kind's fused block: the
        largest difference of its output from the reference block's on the
        same input, over the reference's largest (``precision``: the
        reference at that precision in the program's place)."""
        with _tf32_off():
            return self.of_kind.block_gaps(self, blocks, precision)


class _tf32_off:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.grad = torch.no_grad()
        self.grad.__enter__()

    def __exit__(self, *exc):
        self.grad.__exit__(*exc)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


class Tap:
    """Wraps the predictor's ``apply_model``, the chain's re-quantization
    (``DENOISED``), the kind's featurizer (``FEATURIZERS``) and its fused
    block (``FUSED``): counts each stream's windows as they are dispatched
    and keeps, for the sampled streams' windows whose index lies in
    ``[first, first + K)``, the featurizer's input, the model input and the
    logits, and for the first ``BLOCK_WINDOWS`` of them each fused block's
    input and output; and the denoised window (int16) of every window of a
    sampled stream from its first, which the reference's detector replays.

    ``rows_of()`` names the streams of the batch's rows in order (the
    multiplexer's pending list, read while it dispatches; a session's one
    stream).  ``first`` is set when the measured window opens."""

    def __init__(self, pred, rows_of, sampled, K: int, of_kind):
        self.pred = pred
        self.rows_of = rows_of
        self.sampled = set(sampled)
        self.K = K
        self.of_kind = of_kind
        self.count = defaultdict(int)     # stream -> windows dispatched
        self.first: dict = {}
        self.kept: dict = {}      # (stream, index) -> (x, logits, feat_in)
        self.batches: list = []           # batch sizes while recording
        self.recording = False
        self.feat_in = None               # the last featurizer call's args
        self.blocks: dict = {}    # (stream, index) -> [(x, out)] a call
        self.block_rows = None            # (row, window) of this batch
        self.denoised: dict = {}  # (stream, index) -> int16 window
        self.real = pred.apply_model
        pred.apply_model = self
        self.patched = []
        for mod_name, name in DENOISED:
            self._patch(mod_name, name, self._denoised)
        for mod_name, name in of_kind.FEATURIZERS:
            self._patch(mod_name, name, self._featurizer)
        for mod_name, name in of_kind.FUSED:
            self._patch(mod_name, name, self._block)

    def _patch(self, mod_name, name, wrap):
        mod = importlib.import_module(mod_name)
        real = getattr(mod, name)
        self.patched.append((mod, name, real))
        setattr(mod, name, wrap(real))

    def _denoised(self, real):
        def quantize(*args, **kw):
            out = real(*args, **kw)
            rows = out[None] if out.dim() == 1 else out
            for r, s in enumerate(self.rows_of()):
                j = self.count[s]
                f = self.first.get(s)
                if s in self.sampled and (f is None or j < f + self.K):
                    self.denoised[(s, j)] = rows[r].to(torch.int16)
            return out
        return quantize

    def _featurizer(self, real):
        def featurize(*args, **kw):
            self.feat_in = args
            return real(*args, **kw)
        return featurize

    def _block(self, real):
        def block(x, *args, **kw):
            out = real(x, *args, **kw)
            for r, key in self.block_rows or ():
                self.blocks.setdefault(key, []).append(
                    (x[r].clone(), out[r].clone()))
            return out
        return block

    def _wanted(self, s, j) -> bool:
        f = self.first.get(s)
        return s in self.sampled and f is not None and f <= j < f + self.K

    def __call__(self, x, model=None):
        names = self.rows_of()
        room = self.of_kind.BLOCK_WINDOWS - len(self.blocks)
        if room > 0:
            self.block_rows = [(r, (s, self.count[s]))
                               for r, s in enumerate(names)
                               if self._wanted(s, self.count[s])][:room]
        try:
            logits = self.real(x, model)
        finally:
            self.block_rows = None
        if self.recording:
            self.batches.append(x.shape[0])
        args, self.feat_in = self.feat_in, None
        for r, s in enumerate(names):
            j = self.count[s]
            self.count[s] = j + 1
            if self._wanted(s, j):
                fin = None if args is None else \
                    self.of_kind.featurizer_row(args, r)
                self.kept[(s, j)] = (x[r].clone(), logits[r].clone(), fin)
        return logits

    def open(self, streams) -> None:
        """The measured window opens: each stream's next index is its
        first compared one."""
        for s in streams:
            self.first[s] = self.count[s]

    def detach(self) -> None:
        self.pred.apply_model = self.real
        for mod, name, real in self.patched:
            setattr(mod, name, real)
        self.patched = []
