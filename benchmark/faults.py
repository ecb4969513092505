"""Faults planted underneath the timed path: each makes the program wrong
in one way a cell can be wrong, and ``correct`` must come out false under
it. The benchmark's tests plant them on the CPU; ``calibrate.py --fault``
reads a training fault's numbers on the card, where they set an upper
reading of a limit."""

from contextlib import contextmanager
from typing import Callable, Dict, Iterator

import torch


def _patch(owner, name: str, make: Callable) -> Callable[[], None]:
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    return lambda: setattr(owner, name, orig)


def last_step_unchanged():
    """The sampler's last step returns its state unchanged."""
    from vq_voice_swap_torch.diffusion.process import Diffusion

    def make(orig):
        def broken(self, x_T, predictor, steps, **kw):
            seen = []

            def pred(x, ts):
                seen.append(x)
                return predictor(x, ts)

            orig(self, x_T, pred, steps, **kw)
            return seen[-1]
        return broken

    return _patch(Diffusion, "dpmpp_sample", make)


def half_batch_decoded():
    """Half of the batch decoded; its outputs stand in for the rest."""
    from vq_voice_swap_torch.vq_vae import VQVAE

    def make(orig):
        def broken(self, codes, labels=None, x_T=None, **kw):
            half = codes.shape[0] // 2
            out = orig(self, codes[:half], labels[:half], x_T=x_T[:half], **kw)
            return torch.cat([out, out[:codes.shape[0] - half]])
        return broken

    return _patch(VQVAE, "decode", make)


def code_altered():
    """One code of every clip altered where the encode produces it."""
    from vq_voice_swap_torch.vq_vae import VQVAE

    def make(orig):
        def broken(self, inputs):
            codes = orig(self, inputs).clone()
            codes[:, 1] = (codes[:, 1] + 1) % self.dictionary_size
            return codes
        return broken

    return _patch(VQVAE, "encode", make)


def sample_altered():
    """A stretch of every waveform altered where the decode produces it."""
    from vq_voice_swap_torch.vq_vae import VQVAE

    def make(orig):
        def broken(self, *args, **kw):
            out = orig(self, *args, **kw).clone()
            out[:, 100:200] += 0.5
            return out
        return broken

    return _patch(VQVAE, "decode", make)


def update_unchanged():
    """The optimizer's step leaves the parameters as they were."""
    from vq_voice_swap_torch.train.state import Optimizer

    def make(orig):
        def broken(self):
            kept = [p.detach().clone() for p in self.params]
            orig(self)
            with torch.no_grad():
                for p, k in zip(self.params, kept):
                    p.copy_(k)
        return broken

    return _patch(Optimizer, "step", make)


def half_batch_loss():
    """The training loss leaves out half of the batch: its mean is taken
    over the rest."""
    from vq_voice_swap_torch.vq_vae import VQVAE

    def make(orig):
        def broken(self, inputs, labels=None, ts=None, epsilon=None, **kw):
            half = inputs.shape[0] // 2
            return orig(self, inputs[:half], labels[:half], ts=ts[:half],
                        epsilon=epsilon[:half], **kw)
        return broken

    return _patch(VQVAE, "losses", make)


FAULTS: Dict[str, Dict[str, Callable]] = {
    "swap": {"last_step_unchanged": last_step_unchanged, "half_batch": half_batch_decoded,
             "code_altered": code_altered, "sample_altered": sample_altered},
    "train": {"update_unchanged": update_unchanged, "half_batch": half_batch_loss},
}


@contextmanager
def planted(driver: str, name: str) -> Iterator[None]:
    """Run the body with fault ``name`` of a driver's cells planted."""
    undo = FAULTS[driver][name]()
    try:
        yield
    finally:
        undo()
