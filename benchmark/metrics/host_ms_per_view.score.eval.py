"""Host milliseconds a scored view inside the program's ``score`` spans
(PSNR and the host SSIM), over the traced window."""
from benchmark.readers import span_host_ms

read = span_host_ms("score", "eval")
