from .darknet_csp import DarknetCSP

__all__ = ['DarknetCSP']
