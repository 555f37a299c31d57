"""Native (C++) comm components: the wire codec and the BPE tokenizer,
built with g++ at first use (``build.py``)."""
