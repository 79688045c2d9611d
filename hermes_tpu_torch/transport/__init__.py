"""Host byte codecs of the port (``transport.codec``); the wire codecs
wait for the serving slice (ROADMAP A13)."""
