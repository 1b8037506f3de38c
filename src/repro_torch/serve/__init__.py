"""Serving layer (docs/serving.md). Only ``delta_index`` — the commit-time
touched-row summary the checkpoint writers stamp into manifests — is ported
so far; the subscriber and embedding server come with a later slice."""
