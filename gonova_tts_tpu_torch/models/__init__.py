"""Models of the port: layers, acoustic model, Vocos vocoder, pipeline, weight loading."""
