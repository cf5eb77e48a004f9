"""The two decoders, iSTFTNet (``istftnet``) and HiFi-GAN (``hifigan``), and
the forward that picks between them after the module's type."""

from . import hifigan, istftnet


def decoder_apply(m: istftnet.Decoder, *args, **kwargs):
    """The forward of ``m``: ``hifigan.decoder_apply`` for a
    ``hifigan.Decoder``, else ``istftnet.decoder_apply`` (the JAX package
    picks the module from ``mp.decoder.type``), with the same arguments."""
    mod = hifigan if isinstance(m, hifigan.Decoder) else istftnet
    return mod.decoder_apply(m, *args, **kwargs)
