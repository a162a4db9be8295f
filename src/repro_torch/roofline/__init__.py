"""The roofline (``analysis``): counted FLOPs and bytes of a step against
the H100's peaks."""
