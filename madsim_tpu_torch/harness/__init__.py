from .witness import success_witness

__all__ = ["success_witness"]
