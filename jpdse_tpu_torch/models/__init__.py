"""Networks of the port: layers, generator/encoder, the standard codec and
its space-to-depth fast path."""
