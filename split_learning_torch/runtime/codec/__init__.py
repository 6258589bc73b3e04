"""Wire codec layer.  Only the framework-free grammar (``specs``) is
ported so far: the config schema validates ``transport.codec`` with it.
The codecs themselves wait for the protocol slice."""
