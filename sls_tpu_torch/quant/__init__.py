"""int8 dynamic quantization for serving (``quant/int8.py``)."""
