"""File codecs of the port: .ri, .tags (whole and streamed), .rl_bwt and
the GBZ graph container (simple-sds)."""
