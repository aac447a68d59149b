"""GE2E multilingual speaker encoder with domain adaptation (port of
masg_tpu/models/speaker_encoder.py).

Used two ways, as in the reference:
  1. standalone speaker-verification training (GE2E softmax loss over N x M
     language-balanced batches, `train/ge2e.py`);
  2. the language discriminator of the FastSpeech2 trainers, frozen
     (`--use_clf`) or trained jointly (ganlike): predicted mels are chunked
     into 150-frame windows and scored (`train/step.py`).

Parameter names are the reference's (speech_embedder_net.py:65-187), the
names masg_tpu's `export_torch_ge2e` writes: `LSTM_stack` (an `nn.LSTM`
with torch's two biases per gate), `projection.linear_layer` and
`da_classifier.classifier.layer.linear_{0,1,2}.linear_layer`. masg_tpu runs
the LSTM as a flax scan outside any Pallas kernel; here it is `nn.LSTM`
(cuDNN on the card).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class _LinearNorm(nn.Module):
    """The reference's Linear wrapper: its weights sit under `.linear_layer`."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_layer = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_layer(x)


class _DAClassifier(nn.Module):
    """MLP proj -> proj -> proj -> 1 with dropout 0.2 after each hidden Linear,
    then ReLU (module.py MultiLayerNN). Its GradReverse is bypassed in the
    reference: DA trains through the loss-sign schedule instead."""

    def __init__(self, proj: int, dropout: float = 0.2):
        super().__init__()
        self.classifier = nn.Module()
        self.classifier.layer = nn.ModuleDict({
            "linear_0": _LinearNorm(proj, proj),
            "linear_1": _LinearNorm(proj, proj),
            "linear_2": _LinearNorm(proj, 1),
        })
        self.dropouts = nn.ModuleList([nn.Dropout(dropout), nn.Dropout(dropout)])

    def forward(self, e: torch.Tensor) -> torch.Tensor:
        layer = self.classifier.layer
        h = e
        for j in range(2):
            h = F.relu(self.dropouts[j](layer[f"linear_{j}"](h)))
        return layer["linear_2"](h)[..., 0]


class SpeechEmbedder(nn.Module):
    """n_layers-layer LSTM(n_mels -> hidden), last frame -> Linear(proj),
    L2-normalized; plus the language head (`use_da`).

    Reference speech_embedder_net.py:65-140 (config hidden=256, num_layer=3,
    proj=64). A fresh model takes masg_tpu's init (`init_like_masg_tpu`).
    """

    def __init__(self, n_mels: int = 80, hidden: int = 256, n_layers: int = 3,
                 proj: int = 64, use_da: bool = True):
        super().__init__()
        self.n_mels, self.hidden, self.n_layers, self.proj = n_mels, hidden, n_layers, proj
        self.use_da = use_da
        self.LSTM_stack = nn.LSTM(n_mels, hidden, num_layers=n_layers, batch_first=True)
        self.projection = _LinearNorm(hidden, proj)
        if use_da:
            self.da_classifier = _DAClassifier(proj)
        self.init_like_masg_tpu()

    @torch.no_grad()
    def init_like_masg_tpu(self) -> None:
        """masg_tpu's init, flax's defaults (masg_tpu/models/speaker_encoder.py:
        OptimizedLSTMCell, Dense): each gate's input kernel lecun-normal (a
        normal of variance 1 / fan_in truncated at 2 sigma), each gate's
        recurrent kernel orthogonal, the projection and the language head
        lecun-normal, every bias zero (so both biases of a gate stay equal, as
        masg_tpu's folded bias assumes). The reference's init (xavier-normal
        LSTM, torch's default Linear) left the language head at chance
        (16 ln 2 a 4 x 4 batch) through a 40-epoch GE2E run of the demo."""
        def lecun(w: torch.Tensor) -> None:
            std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std)

        h = self.hidden
        for name, param in self.LSTM_stack.named_parameters():
            if name.startswith("bias"):
                param.zero_()
            for g in range(4):  # gates i, f, g, o, one (H, fan_in) block each
                if name.startswith("weight_ih"):
                    lecun(param[g * h:(g + 1) * h])
                elif name.startswith("weight_hh"):
                    nn.init.orthogonal_(param[g * h:(g + 1) * h])
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun(m.weight)
                m.bias.zero_()

    def main_parameters(self):
        """The LSTM and the projection: the GE2E trainer's main group."""
        return [p for n, p in self.named_parameters() if not n.startswith("da_classifier.")]

    def da_parameters(self):
        """The language head: the GE2E trainer's DA group."""
        return [p for n, p in self.named_parameters() if n.startswith("da_classifier.")]

    def forward(self, mels: torch.Tensor, detach: bool = False) -> Dict[str, torch.Tensor]:
        """mels (B, T, n_mels) -> {'embeddings' (B, proj), 'da_lang_logits'
        (B,) when use_da}. `detach` stops the head's gradient at the
        embedding. The head's dropout follows its modules' train/eval mode
        (`discriminator_mode` keeps it off in a train-mode LSTM)."""
        x, _ = self.LSTM_stack(mels.to(self.projection.linear_layer.weight.dtype))
        last = x[:, -1]  # only the last frame (speech_embedder_net.py:109-111)
        emb = self.projection(last)
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        out = {"embeddings": emb}
        if self.use_da:
            out["da_lang_logits"] = self.da_classifier(emb.detach() if detach else emb)
        return out


def discriminator_mode(embedder: nn.Module) -> nn.Module:
    """Train mode with every dropout off: masg_tpu's `deterministic=True`
    for a discriminator that gradients flow through.

    The LSTM stays in train mode (its inter-layer dropout is 0, so the mode
    changes nothing in it) because cuDNN refuses an RNN backward in eval
    mode; only the head's Dropout modules go to eval."""
    embedder.train()
    for m in embedder.modules():
        if isinstance(m, nn.Dropout):
            m.eval()
    return embedder


# ---------------------------------------------------------------------------
# GE2E similarity + losses (reference utils.py:16-135)
# ---------------------------------------------------------------------------


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    num = (a * b).sum(-1)
    return num / (torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
                  + 1e-12)


def ge2e_similarity(embeddings: torch.Tensor) -> torch.Tensor:
    """(N, M, D) -> (N, M, N) cosine similarity to speaker centroids.

    For j == k the centroid excludes the utterance itself
    (utils.py:27-37,57-75).
    """
    n, m, _ = embeddings.shape
    centroids = embeddings.mean(dim=1)  # (N, D) include-self
    excl = (embeddings.sum(dim=1, keepdim=True) - embeddings) / (m - 1)  # (N, M, D)
    sim = _cos(embeddings[:, :, None, :], centroids[None, None, :, :])  # (N, M, N)
    sim_self = _cos(embeddings, excl)  # (N, M)
    eye = torch.eye(n, dtype=torch.bool, device=embeddings.device)[:, None, :]  # (N, 1, N)
    return torch.where(eye, sim_self[:, :, None], sim)


def ge2e_softmax_loss(similarity: torch.Tensor) -> torch.Tensor:
    """sum_ji[ log(sum_k exp(S_jik) + 1e-6) - S_jij ] (utils.py:126-135)."""
    n = similarity.shape[0]
    idx = torch.arange(n, device=similarity.device)
    lse = torch.log(torch.exp(similarity).sum(dim=2) + 1e-6)  # (N, M)
    own = similarity[idx, :, idx]  # (N, M)
    return lse.sum() - own.sum()


def ge2e_contrast_loss(similarity: torch.Tensor) -> torch.Tensor:
    """sum_ji[ 1 - sigmoid(S_jij) + max_{k != j} sigmoid(S_jik) ]
    (utils.py:106-124)."""
    n = similarity.shape[0]
    idx = torch.arange(n, device=similarity.device)
    sig = torch.sigmoid(similarity)
    own = sig[idx, :, idx]
    eye = torch.eye(n, dtype=torch.bool, device=similarity.device)[:, None, :]
    others = torch.where(eye, torch.zeros_like(sig), sig)
    return (1.0 - own).sum() + others.amax(dim=2).sum()


class GE2ELossParams(nn.Module):
    """The learned affine on the similarity matrix, w = 10, b = -5 at init
    (speech_embedder_net.py:165-166)."""

    def __init__(self, w: float = 10.0, b: float = -5.0):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(float(w)))
        self.b = nn.Parameter(torch.tensor(float(b)))


def init_ge2e_params() -> GE2ELossParams:
    return GE2ELossParams()


def bce_with_logits_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """nn.BCEWithLogitsLoss(reduction='sum') in masg_tpu's formula."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).sum()


def ge2e_loss(params: GE2ELossParams, embeddings: torch.Tensor,
              lang_logits: Optional[torch.Tensor], langs: Optional[torch.Tensor],
              loss_type: str = "softmax"
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, ge2e_part, da_part) — reference speech_embedder_net.py:173-187."""
    w = params.w.clamp(min=1e-6)
    sim = w * ge2e_similarity(embeddings) + params.b
    loss = ge2e_contrast_loss(sim) if loss_type == "contrast" else ge2e_softmax_loss(sim)
    if lang_logits is not None:
        da = bce_with_logits_sum(lang_logits, langs)
    else:
        da = torch.zeros((), dtype=loss.dtype, device=loss.device)
    return loss + da, loss, da


def chunk_mels(mel: torch.Tensor, chunk: int = 150) -> torch.Tensor:
    """(B, T, n_mels) -> (B * (T // chunk + 1), chunk, n_mels), zero-padded.

    Always pads, as the reference's `max_len // 150 + 1` (train.py:181-184,
    ganlike.py:39-44)."""
    b, t, n = mel.shape
    n_chunks = t // chunk + 1
    mel = F.pad(mel, (0, 0, 0, n_chunks * chunk - t))
    return mel.reshape(b * n_chunks, chunk, n)
