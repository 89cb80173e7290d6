"""File codecs of the port: what loading and writing .ri and .tags needs."""
