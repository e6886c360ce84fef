"""FourierNet's train/test pipeline (the JAX package's
``training/fouriernet_pipeline.py``; reference
``Layers_Segment/FourierNet/trainTestModels.py``), the reference's only
complete training loop:

- data (``taskLists``, :78-92): z-scored images, z-scored FD-map targets
  (``ops/fd.fd_maps``), one-hot binarized gold masks (``prepare_dataset``);
  the folder reads of ``readOneDataset`` (``read_folder_dataset``, which
  ``cli infer --image-dir`` also reads);
- training (``trainModel``, :94-107): MSE per FD head plus categorical
  cross-entropy on the 2-class head (probabilities clipped at 1e-7),
  Adadelta (lr 0.01, rho 0.9, eps 1e-6, as ``optax.adadelta``), shuffled
  batches, the parameters of the best validation loss kept and early
  stopping with patience (``EarlyStopping``);
- inference (``testUnet``, :128-133): class-1 probability maps.

The trainer runs on ``device``, a CUDA device unless the caller asks for
the CPU. The shuffles and dropout masks come from ``torch.Generator``s
seeded from ``seed``; JAX's come from its own keys, so the two trainers'
runs agree only where neither draws (one step at dropout 0, the loss).
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from ..models.fouriernet import FourierNet
from ..ops.fd import fd_maps
from .checkpoint import EarlyStopping
from .png_volumes import _imread


def zscore_image(img: np.ndarray) -> np.ndarray:
    """Per-image z-score (reference ``readOneImage``, :17)."""
    return (img - img.mean()) / (img.std() + 1e-7)


def list_image_files(directory: str) -> list[str]:
    """Sorted image filenames in a directory (reference
    ``listAllImageFiles``, :62-69)."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
    return sorted(
        f for f in os.listdir(directory) if f.lower().endswith(exts)
    )


def read_folder_dataset(image_dir: str, gold_dir: str | None = None):
    """-> (images (N, H, W) float32 grey levels, masks (N, H, W) uint8 in
    {0, 1} or None, names): the reference's ``readOneDataset`` flow
    (:38-59); gold masks are binarized (:31-34). Images are read with cv2,
    else PIL."""
    names = list_image_files(image_dir)
    images, masks = [], []
    for n in names:
        images.append(_imread(os.path.join(image_dir, n)).astype(np.float32))
        if gold_dir is not None:
            gold = _imread(os.path.join(gold_dir, n))
            masks.append((gold > 0).astype(np.uint8))
    images = np.stack(images)
    masks = np.stack(masks) if masks else None
    return images, masks, names


def prepare_dataset(images: np.ndarray, masks: np.ndarray,
                    fd_channel: int = 1):
    """(N, H, W) images and binary masks -> float32 NHWC arrays (inputs
    (N, H, W, 1), FD targets (N, H, W, fd_channel), one-hot masks
    (N, H, W, 2)), as ``taskLists`` (:78-92) builds them."""
    xs, fds, ys = [], [], []
    for img, msk in zip(images, masks):
        xs.append(zscore_image(img.astype(np.float64))[..., None])
        fds.append(zscore_image(fd_maps((msk > 0).astype(np.uint8),
                                        fd_channel)))
        binm = (msk > 0).astype(int)
        onehot = np.zeros(msk.shape + (2,))
        onehot[..., 0] = 1 - binm
        onehot[..., 1] = binm
        ys.append(onehot)
    return (np.stack(xs).astype(np.float32),
            np.stack(fds).astype(np.float32),
            np.stack(ys).astype(np.float32))


@dataclasses.dataclass
class FourierNetTrainer:
    fd_channel: int = 1
    features: Sequence[int] = (16, 32, 64, 128, 256)
    dropout: float = 0.2
    learning_rate: float = 0.01  # reference main, :158
    max_epochs: int = 500  # reference trainModel, :105
    patience: int = 50  # reference createCallbacks, :74
    batch_size: int = 4
    seed: int = 0
    in_channels: int = 1
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA device "
                               "available (ask for the CPU explicitly)")
        self.model = FourierNet(
            self.in_channels, self.fd_channel, tuple(self.features),
            self.dropout, generator=torch.Generator().manual_seed(self.seed),
        ).to(self.device)
        self.history: list[dict] = []

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def loss(self, batch, generator: torch.Generator | None = None,
             train: bool = True) -> torch.Tensor:
        """Per-head MSE + CCE (``deepModels.py:85-89``) of a batch of NHWC
        (inputs, FD targets, one-hot masks); dropout draws from
        ``generator`` in train mode."""
        x, fd_t, y_t = (self._tensor(a) for a in batch)
        self.model.train(train)
        fd_out, final = self.model(x.permute(0, 3, 1, 2), generator)
        loss = 0.0
        for i in range(self.fd_channel):
            loss = loss + torch.mean((fd_out[i][:, 0] - fd_t[..., i]) ** 2)
        # jnp.clip's gradient: maximum then minimum
        p = torch.minimum(torch.maximum(final, final.new_tensor(1e-7)),
                          final.new_tensor(1.0))
        cce = -torch.mean(torch.sum(y_t.permute(0, 3, 1, 2) * torch.log(p),
                                    dim=1))
        return loss + cce

    def init(self) -> torch.optim.Optimizer:
        """Adadelta over the model's parameters."""
        return torch.optim.Adadelta(self.model.parameters(),
                                    lr=self.learning_rate, rho=0.9, eps=1e-6)

    def fit(self, train_data, val_data) -> dict:
        """Train on NHWC arrays from ``prepare_dataset``; -> the state dict
        of the best validation loss, which the model then holds."""
        x, fd_t, y_t = (self._tensor(a) for a in train_data)
        val = tuple(self._tensor(a) for a in val_data)
        opt = self.init()
        stopper = EarlyStopping(self.patience)
        best = copy.deepcopy(self.model.state_dict())
        n = x.shape[0]
        shuffle = torch.Generator().manual_seed(self.seed + 1)
        drop = torch.Generator(device=self.device).manual_seed(self.seed + 2)
        self.history = []
        for epoch in range(self.max_epochs):
            order = torch.randperm(n, generator=shuffle).to(self.device)
            ep_loss, nb = 0.0, 0
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                sel = order[i:i + self.batch_size]
                opt.zero_grad(set_to_none=True)
                loss = self.loss((x[sel], fd_t[sel], y_t[sel]), drop)
                loss.backward()
                opt.step()
                ep_loss += loss.item()
                nb += 1
            with torch.no_grad():
                vloss = float(self.loss(val, train=False))
            self.history.append({"epoch": epoch,
                                 "loss": ep_loss / max(nb, 1),
                                 "val_loss": vloss})
            if vloss < stopper.best:
                best = copy.deepcopy(self.model.state_dict())
            if stopper.update(epoch, vloss):
                break
        self.model.load_state_dict(best)
        return best

    @torch.no_grad()
    def predict(self, params: dict | None, x, batch_size: int = 4
                ) -> np.ndarray:
        """Class-1 probability maps (N, H, W) of NHWC images, eval mode
        (``testUnet`` / :170-174); ``params`` a state dict to load first,
        or None for the model as it is."""
        if params is not None:
            self.model.load_state_dict(params)
        self.model.eval()
        x = self._tensor(x)
        outs = [self.model(x[i:i + batch_size].permute(0, 3, 1, 2))[1][:, 1]
                for i in range(0, x.shape[0], batch_size)]
        return torch.cat(outs).cpu().numpy()
