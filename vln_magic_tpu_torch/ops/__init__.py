from .attention import fused_attention, fused_attention_reference
