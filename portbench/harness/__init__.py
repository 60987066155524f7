"""The general parts of a run: the manifest, loading by name, spans, the
trace's reading and the run itself."""
