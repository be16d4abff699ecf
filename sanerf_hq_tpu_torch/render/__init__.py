from .renderer import RenderSettings, render_rays, render_staged
