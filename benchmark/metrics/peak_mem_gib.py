"""``torch.cuda.max_memory_allocated`` over the untraced window, in GiB."""
from benchmark.readers import peak_mem_gib as read
