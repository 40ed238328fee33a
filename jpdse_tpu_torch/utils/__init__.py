"""Host-side helpers: path sorting, image conversion, label colors and the
HTML gallery of an evaluation."""
