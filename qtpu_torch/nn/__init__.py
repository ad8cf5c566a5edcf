from qtpu_torch.nn.config import LayerQuantSpec, QuantPolicy

__all__ = ["LayerQuantSpec", "QuantPolicy"]
